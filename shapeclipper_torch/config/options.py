"""YAML config system with `_parent_` inheritance and dotted CLI overrides.

Behavioral parity with the reference options system (reference
`utils/options.py:16-119`):
  * CLI syntax `--key1.key2=value` with YAML-typed values; `--flag` means
    true, `--flag!` means false
  * YAML files may declare `_parent_` (string or list) whose options are
    loaded first and then overridden
  * overriding an unknown key is guarded (non-interactive here: raises unless
    `--force_add` is passed, since TPU jobs are headless)
  * seeding and output-dir resolution; seedless runs get a random 4-char
    run-name suffix
  * per-run `options.yaml` persisted; a differing existing file aborts unless
    `--force_override` is passed
"""

from __future__ import annotations

import os
import random
import string
import sys

import numpy as np
import yaml

from ..utils.easydict import EasyDict as edict, to_plain_dict
from ..utils.log import log


def parse_arguments(args):
    """Parse `--key1.key2=value` style args into a nested EasyDict."""
    opt_cmd = {}
    for arg in args:
        assert arg.startswith("--"), f"invalid argument {arg!r}"
        if "=" not in arg[2:]:
            key_str, value = (arg[2:-1], "false") if arg[-1] == "!" else (arg[2:], "true")
        else:
            key_str, value = arg[2:].split("=", 1)
        keys_sub = key_str.split(".")
        opt_sub = opt_cmd
        for k in keys_sub[:-1]:
            if k not in opt_sub:
                opt_sub[k] = {}
            opt_sub = opt_sub[k]
        assert keys_sub[-1] not in opt_sub, f"duplicate key {keys_sub[-1]}"
        opt_sub[keys_sub[-1]] = yaml.safe_load(value)
    return edict(opt_cmd)


def pop_arg(argv, key):
    """Strip `--key=value` from argv (a flag of the port's CLIs, not a
    config key) -> (value or None, the other arguments)."""
    val = None
    rest = []
    for a in argv:
        if a.startswith(f"--{key}="):
            val = a.split("=", 1)[1]
        else:
            rest.append(a)
    return val, rest


def pop_device(argv):
    """Strip `--device=cuda|cpu` from argv -> (device, the other
    arguments); cuda when absent."""
    device, rest = pop_arg(argv, "device")
    device = device or "cuda"
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {device!r}")
    return device, rest


def load_options(fname):
    with open(fname) as file:
        opt = edict(yaml.safe_load(file))
    if "_parent_" in opt:
        parent_fnames = opt.pop("_parent_")
        if isinstance(parent_fnames, str):
            parent_fnames = [parent_fnames]
        for parent_fname in parent_fnames:
            opt_parent = load_options(parent_fname)
            opt_parent = override_options(opt_parent, opt, key_stack=[])
            opt = opt_parent
    print(f"loading {fname}...")
    return opt


def override_options(opt, opt_over, key_stack=None, safe_check=False,
                     force_add=False):
    # `--force_add` adds nested keys too (`--tpu.profile_iters=[1,3]`); the
    # JAX package's check reads it at the top level only
    force_add = force_add or bool(opt_over.get("force_add")
                                  or opt.get("force_add"))
    for key, value in opt_over.items():
        if isinstance(value, dict):
            # `or edict()`: a key present with a null value (e.g. `mesh:`)
            # accepts a dict override
            base = opt.get(key) or edict()
            opt[key] = override_options(
                base, value, key_stack=key_stack + [key],
                safe_check=safe_check and bool(opt.get(key)),
                force_add=force_add)
        else:
            if safe_check and key not in opt and key not in _ALWAYS_ALLOWED_KEYS:
                key_str = ".".join(key_stack + [key])
                if force_add:
                    print(f'adding new key "{key_str}"')
                else:
                    raise KeyError(
                        f'"{key_str}" not found in original opt; pass --force_add '
                        f"to add new keys in headless runs")
            opt[key] = value
    return opt


# keys injected by runners / CLIs that are not necessarily in the YAML
_ALWAYS_ALLOWED_KEYS = {"force_add", "force_override", "yaml", "device", "world_size"}


def set(opt_cmd=None):
    """Load the YAML named by --yaml, apply CLI overrides, resolve run options."""
    opt_cmd = opt_cmd if opt_cmd is not None else edict()
    log.info("setting configurations...")
    fname = opt_cmd.get("yaml")
    assert fname, "pass --yaml=<config file>"
    opt_base = load_options(fname)
    opt = override_options(opt_base, opt_cmd, key_stack=[], safe_check=True)
    process_options(opt)
    log.options(opt)
    return opt


def process_options(opt):
    if opt.get("seed") is not None:
        random.seed(opt.seed)
        np.random.seed(opt.seed)
    else:
        randkey = "".join(random.choice(string.ascii_uppercase) for _ in range(4))
        opt.name = f"{opt.name}_{randkey}"
    opt.output_path = "{0}/{1}/{2}".format(opt.output_root, opt.group, opt.name)
    os.makedirs(opt.output_path, exist_ok=True)
    opt.H, opt.W = opt.image_size
    return opt


def save_options_file(opt):
    opt_fname = f"{opt.output_path}/options.yaml"
    opt_plain = to_plain_dict(opt)
    if os.path.isfile(opt_fname):
        with open(opt_fname) as file:
            opt_old = yaml.safe_load(file)
        if opt_plain != opt_old:
            if opt.get("force_override") or not sys.stdin.isatty():
                print("existing options file found (different); overriding")
            else:
                override = None
                while override not in ["y", "n"]:
                    override = input("override? (y/n) ")
                if override == "n":
                    print("safe exiting...")
                    sys.exit(0)
        else:
            print("existing options file found (identical)")
    else:
        print("(creating new options file...)")
    with open(opt_fname, "w") as file:
        yaml.safe_dump(opt_plain, file, default_flow_style=False, indent=4)
