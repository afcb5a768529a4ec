"""The port's errors, as tpu7z/utils/errors.py names them: exceptions on
the host's control path, one base class for all."""


class TpuzError(Exception):
    """Base class of every error the port raises for its input."""


class CorruptError(TpuzError):
    """The input violates its format."""


class UnsupportedError(TpuzError):
    """A valid feature the port does not decode."""


class DstTooSmallError(TpuzError):
    """An output buffer too small for what it must hold."""


class ParamError(TpuzError):
    """A parameter out of its range."""
