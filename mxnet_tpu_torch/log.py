"""Logging utilities (reference python/mxnet/log.py): a colored,
level-prefixed formatter and the `get_logger` factory."""
import logging
import sys

CRITICAL, ERROR, WARNING, INFO, DEBUG, NOTSET = (
    logging.CRITICAL, logging.ERROR, logging.WARNING,
    logging.INFO, logging.DEBUG, logging.NOTSET)

PY3 = True


class _Formatter(logging.Formatter):
    """Level-aware formatter with ANSI colors on TTYs
    (reference log.py _Formatter)."""

    def __init__(self, colored=True):
        self.colored = colored
        super(_Formatter, self).__init__()

    def _get_color(self, level):
        if level >= ERROR:
            return '\x1b[31m'
        if level >= WARNING:
            return '\x1b[33m'
        return '\x1b[32m'

    def format(self, record):
        fmt = ''
        if self.colored and sys.stderr.isatty():
            fmt = self._get_color(record.levelno)
        fmt += record.levelname[0]
        fmt += '%(asctime)s %(process)d %(pathname)s:%(funcName)s:' \
               '%(lineno)d'
        if self.colored and sys.stderr.isatty():
            fmt += '\x1b[0m'
        fmt += ' %(message)s'
        self._style._fmt = fmt
        return super(_Formatter, self).format(record)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Create or retrieve a logger with the framework formatter
    (reference log.py getLogger)."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, '_init_done', False):
        logger._init_done = True
        if filename:
            mode = filemode if filemode else 'a'
            hdlr = logging.FileHandler(filename, mode)
            hdlr.setFormatter(_Formatter(colored=False))
        else:
            hdlr = logging.StreamHandler()
            hdlr.setFormatter(_Formatter())
        logger.addHandler(hdlr)
        logger.setLevel(level)
    return logger


getLogger = get_logger
