"""The shadow-translation GANs: networks, losses, trainers, samplers, validation."""
