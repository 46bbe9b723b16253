"""The seven GAN trainers: CycleGAN, vanilla (x2y, y2x), CUT (x2y, y2x), DCLGAN, DCL-CycleGAN."""
