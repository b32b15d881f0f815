"""Unified CLI/env/preset argument layer (common/arg.cpp analogue).

The PyTorch port's own copy of tpullm/utils/args.py (which imports no JAX),
so that the port imports nothing of the JAX package.

The reference gives every flag an environment-variable fallback and layers
--preset profiles under the CLI (common/arg.cpp ~4.1k LoC, common/preset.cpp,
docs/preset.md). Resolution order (highest wins), matching the reference:

    CLI flag  >  environment variable  >  preset file  >  built-in default

- env names derive from the dest: ``--ctx-size`` -> TPULLM_CTX_SIZE
  (the reference uses LLAMA_ARG_*).
- presets are JSON files ({"ctx_size": 4096, "kv_type": "q8"}) selected
  with --preset NAME (searched as ./NAME.json, ~/.config/tpullm/NAME.json)
  or --preset path/to/file.json.

Usage:
    ap = ArgLayer("tpullm_torch.server")
    ap.add("-c", "--ctx-size", type=int, default=2048, help="...")
    args = ap.parse(argv)
"""
from __future__ import annotations

import argparse
import json
import os
import sys


ENV_PREFIX = "TPULLM_"


def _env_name(dest: str) -> str:
    return ENV_PREFIX + dest.upper()


def _find_preset(name: str) -> str | None:
    if os.path.exists(name):
        return name
    for base in (".", os.path.expanduser("~/.config/tpullm")):
        p = os.path.join(base, f"{name}.json")
        if os.path.exists(p):
            return p
    return None


class ArgLayer:
    def __init__(self, prog: str, description: str | None = None):
        self.ap = argparse.ArgumentParser(prog, description=description)
        self.ap.add_argument(
            "--preset", default=os.environ.get(ENV_PREFIX + "PRESET"),
            help="JSON preset profile (name or path); CLI/env override it")
        self._defaults: dict = {}
        self._types: dict = {}

    def add(self, *flags, **kw):
        """argparse.add_argument with an automatic env fallback.

        The declared default moves into the layered resolution so argparse
        itself reports 'unset' (None) and the layer decides. `required`
        is enforced AFTER layering (an env var or preset satisfies it)."""
        default = kw.pop("default", None)
        required = kw.pop("required", False)
        action = kw.get("action")
        a = self.ap.add_argument(*flags, **{**kw, "default": None})
        self._defaults[a.dest] = default
        self._types[a.dest] = (kw.get("type"), action)
        if required:
            self._required = getattr(self, "_required", set()) | {a.dest}
        return a

    def parse(self, argv=None):
        ns = self.ap.parse_args(argv)
        preset: dict = {}
        if ns.preset:
            path = _find_preset(ns.preset)
            if path is None:
                self.ap.error(f"preset not found: {ns.preset}")
            with open(path) as f:
                preset = json.load(f)
            unknown = set(preset) - set(self._defaults)
            if unknown:
                self.ap.error(f"unknown preset keys: {sorted(unknown)}")
        for dest, default in self._defaults.items():
            if getattr(ns, dest, None) is not None:
                continue  # CLI wins
            typ, action = self._types[dest]
            env = os.environ.get(_env_name(dest))
            if env is not None:
                if action in ("store_true", "store_false"):
                    val = env.lower() in ("1", "true", "yes", "on")
                elif action == "append":
                    val = env.split(",")
                else:
                    val = typ(env) if typ else env
                setattr(ns, dest, val)
            elif dest in preset:
                setattr(ns, dest, preset[dest])
            else:
                setattr(ns, dest, default)
        for dest in getattr(self, "_required", ()):
            if getattr(ns, dest, None) is None:
                self.ap.error(f"argument --{dest.replace('_', '-')} is "
                              f"required (flag, {_env_name(dest)}, or preset)")
        return ns
