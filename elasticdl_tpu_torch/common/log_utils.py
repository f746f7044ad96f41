"""Uniform stderr logging (the port's copy of elasticdl_tpu's)."""

import logging

_LOGGER_CACHE = {}

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s"
)


def get_logger(name, level=logging.INFO, handler_stream=None):
    key = (name, level, id(handler_stream))
    if key in _LOGGER_CACHE:
        return _LOGGER_CACHE[key]
    logger = logging.getLogger(name)
    logger.setLevel(level)
    handler = logging.StreamHandler(handler_stream)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    _LOGGER_CACHE[key] = logger
    return logger


default_logger = get_logger("elasticdl_tpu_torch")
