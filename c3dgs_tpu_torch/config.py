"""Config / flag system: dataclass param groups + argparse + JSON round-trip
(port of c3dgs_tpu/config.py; arguments/__init__.py).

ParamGroup reflection (arguments/__init__.py:10-40): every field becomes a
`--name` flag, the fields `shorthands()` names also get `-x`, bools become
store_true. Flag names, shorthands and defaults are the JAX package's,
with one exception: ModelParams.data_device defaults to "cuda", the device
the port's CLIs run on. Configs persist as structured JSON
(`save_config` / `load_combined_args`); a reference-style `cfg_args`
Namespace repr is written beside it and read back by a restricted literal
parser, never by eval().
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import get_type_hints

import torch


@dataclasses.dataclass(frozen=True)
class ParamGroup:
    """Shared argparse bridge."""

    @classmethod
    def add_to_parser(cls, parser: argparse.ArgumentParser, name: str, fill_none=False):
        group = parser.add_argument_group(name)
        hints = get_type_hints(cls)
        for f in dataclasses.fields(cls):
            t = hints.get(f.name, str)
            default = None if fill_none else f.default
            short = cls.shorthands().get(f.name)
            names = [f"--{f.name}"] + ([f"-{short}"] if short else [])
            if t is bool:
                group.add_argument(*names, action="store_true", default=default)
            else:
                group.add_argument(*names, type=t, default=default)

    @classmethod
    def shorthands(cls) -> dict:
        return {}

    @classmethod
    def extract(cls, args) -> "ParamGroup":
        kwargs = {}
        for f in dataclasses.fields(cls):
            v = getattr(args, f.name, None)
            if v is not None:
                kwargs[f.name] = v
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True)
class ModelParams(ParamGroup):
    """arguments/__init__.py:43-74."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False

    @classmethod
    def shorthands(cls):
        return {"source_path": "s", "model_path": "m", "images": "i", "resolution": "r", "white_background": "w"}

    def post_extract(self):
        """Absolute source path; and a data_device that names no torch
        device (the JAX CLI saves "tpu" in cfg_args) becomes the port's
        default, "cuda". A device given on the command line reaches here
        already, as load_combined_args lets it override the saved one."""
        device = self.data_device
        try:
            torch.device(device)
        except RuntimeError:
            device = ModelParams.data_device
        return dataclasses.replace(
            self,
            source_path=os.path.abspath(self.source_path) if self.source_path else "",
            data_device=device,
        )


@dataclasses.dataclass(frozen=True)
class PipelineParams(ParamGroup):
    """arguments/__init__.py:76-83."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class CompressionParams(ParamGroup):
    """The compression stage's settings (arguments/__init__.py:85-114 and
    the JAX package's extensions: keep quantiles, xyz_fp16).
    importance_include, importance_prune, color_importance_include and
    color_importance_prune are vestigial, as in the reference: declared,
    never read (pruning is prune_threshold, keep thresholds are the
    *_keep_quantile autoset)."""

    load_iteration: int = -1
    start_checkpoint: str = ""
    output_vq: str = ""
    importance_include: float = 0.0
    importance_prune: float = 1.0

    color_codebook_size: int = 2**12
    color_cluster_iterations: int = 100
    color_decay: float = 0.8
    color_batch_size: int = 2**18
    color_compress_non_dir: bool = True
    color_importance_include: float = 0.6 * 1e-6
    color_importance_prune: float = 0.0

    gaussian_codebook_size: int = 2**12
    gaussian_cluster_iterations: int = 800
    gaussian_decay: float = 0.8
    gaussian_batch_size: int = 2**20
    gaussian_importance_include: float = 0.3 * 1e-5

    not_compress_color: bool = False
    not_compress_gaussians: bool = False
    not_sort_morton: bool = False
    not_prune: bool = False
    prune_threshold: float = 0.0

    finetune_iterations: int = 5000

    # keep-quantile autoset of the keep thresholds (compress.py:212-219)
    color_keep_quantile: float = 0.9
    gaussian_keep_quantile: float = 0.75

    # fixed-point uint16 xyz in the npz unless set (models/io_npz.py)
    xyz_fp16: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizationParams(ParamGroup):
    """arguments/__init__.py:116-137 (defaults preserved exactly)."""

    iterations: int = 30_000
    epochs: int = 100
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    not_quantization_aware: bool = False


def save_config(model_path: str, groups: dict) -> None:
    """Write cfg_args.json ({group name: fields}) and the reference-style
    `cfg_args` Namespace repr of all fields."""
    os.makedirs(model_path, exist_ok=True)
    payload = {k: g.to_dict() for k, g in groups.items()}
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(payload, f, indent=2)
    flat = {}
    for g in groups.values():
        flat.update(g.to_dict())
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(argparse.Namespace(**flat)))


def _parse_namespace_repr(text: str) -> dict:
    """Parse `Namespace(a=1, b='x')` without eval (restricted literals)."""
    text = text.strip()
    if not (text.startswith("Namespace(") and text.endswith(")")):
        raise ValueError(f"not a Namespace repr: {text[:40]!r}")
    node = ast.parse(f"dict({text[len('Namespace('):-1]})", mode="eval")
    return {kw.arg: ast.literal_eval(kw.value) for kw in node.body.keywords}


def load_combined_args(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """get_combined_args (arguments/__init__.py:139-159): the model dir's
    saved config (cfg_args.json, else cfg_args) under the command line's
    flags. Parse with fill_none=True groups so that only flags given on
    the command line override."""
    cmdline = parser.parse_args(argv if argv is not None else sys.argv[1:])
    merged = {}
    model_path = getattr(cmdline, "model_path", "")
    if model_path:
        json_path = os.path.join(model_path, "cfg_args.json")
        txt_path = os.path.join(model_path, "cfg_args")
        if os.path.exists(json_path):
            with open(json_path) as f:
                for group in json.load(f).values():
                    merged.update(group)
            print(f"Config loaded: {json_path}")
        elif os.path.exists(txt_path):
            with open(txt_path) as f:
                merged.update(_parse_namespace_repr(f.read()))
            print(f"Config loaded: {txt_path}")
    for k, v in vars(cmdline).items():
        if v is not None:
            merged[k] = v
    return argparse.Namespace(**merged)
