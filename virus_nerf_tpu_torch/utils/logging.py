"""Coloured terminal and file logging.

Counterpart of ``virus_nerf_tpu/utils/logging.py`` (reference:
args/args.py:165-192, args/logging_formatter.py:1-75): one coloured stream
handler, and ``<save_dir>/log.txt`` in plain text when the config names a
``save_dir``.

One difference: the JAX function returns a logger that already has
handlers as it is, so in one process only the first run with a
``save_dir`` gets a ``log.txt``.  Here every call with a ``save_dir``
points the file handler at that run's ``log.txt`` (an earlier run's file
is closed), so each run of a process writes its own.
"""

from __future__ import annotations

import logging
import os

_COLORS = {
    logging.DEBUG: "\x1b[38;21m",
    logging.INFO: "\x1b[38;5;39m",
    logging.WARNING: "\x1b[38;5;226m",
    logging.ERROR: "\x1b[38;5;196m",
    logging.CRITICAL: "\x1b[31;1m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        fmt = f"{color}%(asctime)s %(levelname)s{_RESET} %(message)s"
        return logging.Formatter(fmt, datefmt="%H:%M:%S").format(record)


def make_logger(cfg=None, name: str = "virus_nerf_tpu_torch") -> logging.Logger:
    """The package logger at INFO: a coloured stream handler (added once)
    and, when ``cfg.save_dir`` is set, a file handler on
    ``<save_dir>/log.txt``."""
    logger = logging.getLogger(name)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler()
        sh.setFormatter(_ColorFormatter())
        logger.addHandler(sh)
        logger.propagate = False
    save_dir = getattr(cfg, "save_dir", None) if cfg is not None else None
    if save_dir:
        path = os.path.abspath(os.path.join(save_dir, "log.txt"))
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if not any(h.baseFilename == path for h in files):
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(save_dir, exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(message)s")
            )
            logger.addHandler(fh)
    return logger
