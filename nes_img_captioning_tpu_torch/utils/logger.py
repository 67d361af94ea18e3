"""Aligned stat-table logging, matching the reference's output format
(reference: src/algorithm/tools/utils.py:23-31 and src/main.py:42-45). A
copy of ``nes_img_captioning_tpu/utils/logger.py``."""

from __future__ import annotations

import logging

__all__ = ["log", "setup_logging"]


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        format="[%(asctime)s pid=%(process)d] %(message)s", level=level
    )


def log(name, result):
    try:
        result = "{:g}".format(float("{:.{p}g}".format(result, p=4)))
    except Exception:
        pass
    logging.info(
        "| %s: %s | %s %s |",
        name,
        " " * (max(19 - len(name), 0)),
        " " * (max(10 - len(str(result)), 0)),
        result,
    )
