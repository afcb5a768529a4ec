from .delta import delta_encode, delta_decode
from .bcj import bcj_x86_encode, bcj_x86_decode, FILTERS

__all__ = ["delta_encode", "delta_decode",
           "bcj_x86_encode", "bcj_x86_decode", "FILTERS"]
