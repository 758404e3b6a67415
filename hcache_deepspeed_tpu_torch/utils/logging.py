"""Rank-aware logging.

Counterpart of ``hcache_deepspeed_tpu/utils/logging.py`` (logger +
``log_dist`` rank filtering). The rank is the ``torch.distributed`` rank
when a process group is up, else the ``RANK`` environment variable.
"""

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name="hds_torch", level=logging.INFO):
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"))
        logger_.addHandler(handler)
    return logger_


logger = _create_logger(
    level=LOG_LEVELS.get(os.environ.get("HDS_LOG_LEVEL", "info").lower(), logging.INFO))


def _process_index():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the listed process ranks (None/[-1] = all)."""
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def print_rank_0(message):
    if _process_index() == 0:
        print(message, flush=True)


def warning_once(message, _seen=set()):
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)
