"""Bytes of prediction vectors that CAP's forward materializes a window: the
program's counter ``CAPModule.u_hat_bytes`` (of its last forward, a band)
over the band's windows. None for a program without the counter."""


def read(ctx):
    try:
        from hypelcnn_tpu_torch.models.cap import CAPModule
    except ImportError:
        return None
    counted = getattr(CAPModule, "u_hat_bytes", None)
    if counted is None:
        return None
    return counted / (ctx.traffic["batch_rows"] * ctx.config["scene"]["width"])
