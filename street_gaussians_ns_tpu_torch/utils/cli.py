"""Mini dataclass->argparse bridge (counterpart of
street_gaussians_ns_tpu/utils/cli.py, a copy).

Gives the reference's CLI ergonomics — every config field overridable as
--section.field (README.md:284-291) — by reflecting over the dataclass
tree. Nested dataclasses become dotted prefixes; bools become
--x / --no-x pairs; Optional[List[int]] accepts space-separated values.
"""
from __future__ import annotations

import argparse
import dataclasses
import typing
from pathlib import Path


def _unwrap_optional(t):
    origin = typing.get_origin(t)
    if origin is typing.Union:
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return t, False


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str = "",
                       default=None):
    default = default if default is not None else cls()
    for f in dataclasses.fields(cls):
        name = f"{prefix}{f.name}"
        cur = getattr(default, f.name)
        t, _ = _unwrap_optional(f.type if not isinstance(f.type, str)
                                else typing.get_type_hints(cls)[f.name])
        if dataclasses.is_dataclass(t):
            add_dataclass_args(parser, t, prefix=f"{name}.", default=cur)
            continue
        flag = "--" + name.replace("_", "-")
        origin = typing.get_origin(t)
        if t is bool:
            group = parser.add_mutually_exclusive_group()
            group.add_argument(flag, dest=name, action="store_true",
                               default=cur)
            group.add_argument("--no-" + name.replace("_", "-"), dest=name,
                               action="store_false")
        elif origin in (list, typing.List):
            elem = typing.get_args(t)[0] if typing.get_args(t) else str
            parser.add_argument(flag, dest=name, nargs="*", type=elem,
                                default=cur)
        elif t in (int, float, str):
            parser.add_argument(flag, dest=name, type=t, default=cur)
        elif t is Path:
            parser.add_argument(flag, dest=name, type=Path, default=cur)
        else:
            # Fallback: string-typed.
            parser.add_argument(flag, dest=name, type=str, default=cur)


def dataclass_from_args(cls, args: argparse.Namespace, prefix: str = "",
                        default=None):
    default = default if default is not None else cls()
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        name = f"{prefix}{f.name}"
        t, _ = _unwrap_optional(hints[f.name])
        if dataclasses.is_dataclass(t):
            kwargs[f.name] = dataclass_from_args(
                t, args, prefix=f"{name}.", default=getattr(default, f.name))
        else:
            kwargs[f.name] = getattr(args, name)
    return cls(**kwargs)
