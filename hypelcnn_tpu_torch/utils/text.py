"""Small string and path helpers (``hypelcnn_tpu/utils/text.py``)."""

from __future__ import annotations

import ntpath


def path_leaf(path: str | None) -> str:
    if path is None:
        return ""
    head, tail = ntpath.split(path)
    return tail or ntpath.basename(head)


def replace_abbrs(value: str, abbreviations: dict) -> str:
    for key, abbr in abbreviations.items():
        value = value.replace(key, abbr)
    return value
