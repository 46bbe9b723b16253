"""Interchange with the JAX package's checkpoints."""


class FormatNotRead(ValueError):
    """A checkpoint written in a format, or with an option, the port does not
    read (as opposed to one that is corrupt)."""
