"""External codec loading — the LoadCodecs / DLL-plugin analog.

A copy of tpu7z/utils/plugins.py: the same directories and table, its
codecs registered in the port's registry (models/registry.py), the same
errors.

Behavioral reference: CPP/7zip/UI/Common/LoadCodecs.cpp:569
(LoadExternalCodecs scans plugin directories, queries each module's
exported codec table via GetNumberOfMethods/GetMethodProperty —
CPP/7zip/Compress/CodecExports.cpp:198-340) and registers them beside
the built-ins. The tpu7z equivalent scans `TPU7Z_PLUGIN_DIR` (and
`~/.tpu7z/plugins`) for Python modules exporting a `TPU7Z_CODECS`
table, validates each entry, and registers it in the codec registry.

A plugin module provides:

    TPU7Z_CODECS = [
        {"name": "mycodec", "method_id": 0x7F0001,
         "compress": fn(data, level=..., **kw) -> bytes,
         "decompress": fn(data, **kw) -> bytes,
         "levels": (1, 9)},
    ]
"""

from __future__ import annotations

import importlib.util
import os
import sys

from ..models.registry import CODECS, CodecInfo
from .errors import TpuzError

_REQUIRED = ("name", "method_id", "compress", "decompress")


def plugin_dirs() -> list:
    dirs = []
    env = os.environ.get("TPU7Z_PLUGIN_DIR")
    if env:
        dirs.extend(env.split(os.pathsep))
    dirs.append(os.path.expanduser("~/.tpu7z/plugins"))
    return [d for d in dirs if os.path.isdir(d)]


def _validate(entry: dict, origin: str) -> CodecInfo:
    for k in _REQUIRED:
        if k not in entry:
            raise TpuzError(f"plugin {origin}: codec entry missing "
                            f"'{k}'")
    if not callable(entry["compress"]) or \
            not callable(entry["decompress"]):
        raise TpuzError(f"plugin {origin}: compress/decompress must "
                        "be callable")
    name = str(entry["name"]).lower()
    if not name or name in CODECS:
        raise TpuzError(f"plugin {origin}: codec name '{name}' empty "
                        "or already registered")
    return CodecInfo(name, int(entry["method_id"]), entry["compress"],
                     entry["decompress"],
                     tuple(entry.get("levels", (1, 9))))


def load_plugin_file(path: str) -> list:
    """Import one plugin module and register its codecs. Returns the
    registered codec names."""
    modname = "tpu7z_torch_plugin_" + \
        os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise TpuzError(f"plugin {path}: cannot load")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
        table = getattr(mod, "TPU7Z_CODECS", None)
        if not isinstance(table, (list, tuple)):
            raise TpuzError(f"plugin {path}: no TPU7Z_CODECS table")
        registered = []
        for entry in table:
            info = _validate(entry, path)
            CODECS[info.name] = info
            registered.append(info.name)
        return registered
    except TpuzError:
        sys.modules.pop(modname, None)
        raise
    except Exception as e:
        sys.modules.pop(modname, None)
        raise TpuzError(f"plugin {path}: {e}") from None


def load_plugins(dirs=None) -> dict:
    """Scan plugin directories (LoadCodecs.cpp directory walk).
    Returns {path: [codec names]}; broken plugins are skipped with
    their error recorded under the path."""
    loaded: dict = {}
    for d in (dirs if dirs is not None else plugin_dirs()):
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".py") or fn.startswith("_"):
                continue
            path = os.path.join(d, fn)
            try:
                loaded[path] = load_plugin_file(path)
            except TpuzError as e:
                loaded[path] = str(e)
    return loaded
