"""Exceptions raised by the host-side orchestration (counterpart of
``tadataka_tpu/utils/exceptions.py``).  Device code never raises; it
flags, and the host keyframe logic raises these."""

import sys


class BaseException(Exception):
    def __init__(self, message):
        super().__init__(message)
        self.message = message


class NotEnoughInliersException(BaseException):
    pass


class InvalidDepthException(BaseException):
    pass


def print_error(message):
    print(message, file=sys.stderr)
