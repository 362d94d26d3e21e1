"""The benchmark's plain reference: a frozen copy of the port's plain path
(`hgt_ref`) and the computations that judge a run (`follow`, or the module
a configuration names)."""

import importlib


def module(cfg: dict):
    """The reference module that judges a configuration: the module or
    package `benchmark/reference/<cfg["reference"]>`, `follow` where the
    configuration's file names none."""
    return importlib.import_module(f"{__name__}.{cfg.get('reference', 'follow')}")
