"""Logging setup.

Port of ``geo_deep_learning_tpu/config/logging_config.py`` (reference
``config/logging_config.py:8-20`` + ``config/log_config.yaml``): one
stdout handler on the root logger with the JAX package's format, coloured
by colorlog where it is installed. The CLI calls :func:`setup_logging`;
importing this module configures nothing.
"""

from __future__ import annotations

import logging
import logging.config

_FORMAT = "%(asctime)s %(levelname)-8s %(name)s: %(message)s"


def setup_logging(level: int | str = logging.INFO) -> None:
    handlers: dict = {
        "console": {
            "class": "logging.StreamHandler",
            "formatter": "default",
            "stream": "ext://sys.stdout",
        }
    }
    formatters: dict = {"default": {"format": _FORMAT}}
    try:
        import colorlog  # noqa: F401

        formatters["default"] = {
            "()": "colorlog.ColoredFormatter",
            "format": "%(log_color)s" + _FORMAT,
        }
    except ImportError:
        pass
    logging.config.dictConfig(
        {
            "version": 1,
            "disable_existing_loggers": False,
            "formatters": formatters,
            "handlers": handlers,
            "root": {"level": level, "handlers": ["console"]},
        }
    )
