"""Typed unlearning specs — port of ``repro.api.specs`` (the request
vocabulary of this slice).

A forget request's configuration decomposes into three orthogonal concerns,
each a frozen dataclass:

  ``DampenSpec``  how hard to edit: the SSD/BD dampening hyperparameters
                  (alpha, lambda, and the Balanced-Dampening depth profile
                  b_r / c_m).
  ``HaltSpec``    when to stop: the CAU early-stop target tau, checkpoint
                  cadence, and an optional sweep bound.
  ``ExecSpec``    how to run: Fisher chunking, the CUDA dampening kernel,
                  buffer donation, the drive loop and the numeric path
                  (with ``QuantSpec``, the int8 calibration).

``UnlearnSpec`` composes them under a paper ``mode`` ("ssd" | "cau" |
"bd" | "ficabu"): JSON round-trip via ``to_json``/``from_json``, validation
that raises ``ValueError`` with actionable messages, and ``to_config()``
lowering to the engine-level ``core.cau.UnlearnConfig`` with the
reference's mode mapping. (Refresh, mesh, guard and serving specs come with
later slices.)
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional

from repro_torch.core.cau import UnlearnConfig, check_engine_modes

MODES = ("ssd", "cau", "bd", "ficabu")

_MODE_DOC = ('"ssd" (uniform sweep baseline), "cau" (early stop only), '
             '"bd" (depth profile only), "ficabu" (CAU + BD)')


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _finite(x, name: str, *, positive: bool = False,
            non_negative: bool = False) -> None:
    _require(isinstance(x, (int, float)) and not isinstance(x, bool)
             and math.isfinite(x), f"{name} must be a finite number, got {x!r}")
    if positive:
        _require(x > 0, f"{name} must be > 0, got {x!r}")
    if non_negative:
        _require(x >= 0, f"{name} must be >= 0, got {x!r}")


def _from_dict(cls, d: Any, what: str):
    _require(isinstance(d, dict),
             f"{what} must be a mapping of field names, got {type(d).__name__}")
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    _require(not unknown,
             f"unknown {what} field(s) {sorted(unknown)}; "
             f"expected a subset of {sorted(fields)}")
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class DampenSpec:
    """How hard to edit: SSD dampening + the Balanced-Dampening profile.

    ``balanced=None`` (the default) derives BD on/off from the request mode
    ("bd"/"ficabu" switch it on); an explicit bool overrides the mode.
    """
    alpha: float = 10.0       # SSD selection threshold multiplier
    lam: float = 1.0          # SSD dampening strength
    b_r: float = 10.0         # BD front-end weakening ratio (Eq. 5)
    c_m: Optional[float] = None  # BD profile midpoint; None -> (1+L)/2
    balanced: Optional[bool] = None

    def __post_init__(self):
        _finite(self.alpha, "DampenSpec.alpha", positive=True)
        _finite(self.lam, "DampenSpec.lam", non_negative=True)
        _finite(self.b_r, "DampenSpec.b_r")
        _require(self.b_r >= 1.0,
                 f"DampenSpec.b_r must be >= 1 (S(l) rises from 1 to b_r), "
                 f"got {self.b_r!r}")
        if self.c_m is not None:
            _finite(self.c_m, "DampenSpec.c_m")
        _require(self.balanced is None or isinstance(self.balanced, bool),
                 f"DampenSpec.balanced must be None (follow mode) or a bool, "
                 f"got {self.balanced!r}")


@dataclasses.dataclass(frozen=True)
class HaltSpec:
    """When to stop: CAU early-stop target + checkpoint cadence.

    Ignored (no checkpoints, never stop early) when the request mode has CAU
    off ("ssd"/"bd").
    """
    tau: float = 0.05            # stop when forget accuracy <= tau
    checkpoint_every: int = 4    # partial-inference cadence (paper layers)
    max_layers: Optional[int] = None  # optionally bound the sweep depth

    def __post_init__(self):
        _finite(self.tau, "HaltSpec.tau")
        _require(isinstance(self.checkpoint_every, int)
                 and not isinstance(self.checkpoint_every, bool)
                 and self.checkpoint_every >= 0,
                 f"HaltSpec.checkpoint_every must be an int >= 0 "
                 f"(0 disables checkpoints), got {self.checkpoint_every!r}")
        _require(self.max_layers is None
                 or (isinstance(self.max_layers, int)
                     and not isinstance(self.max_layers, bool)
                     and self.max_layers >= 1),
                 f"HaltSpec.max_layers must be None or an int >= 1, "
                 f"got {self.max_layers!r}")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Calibration of the int8 unlearning path (DESIGN.md §12).

    The engine's quantised path is symmetric int8
    (``repro_torch.optim.compression.q8_*``): one f32 scale per leading-axis
    channel of the reference layout, codes in ±127, dequant-free dampening
    on the codes. The fields pin that contract so a serialized request is
    explicit about the grid it ran on:

    ``bits``          code width — only 8 is implemented (the paper's
                      GEMM-centric datapath is int8).
    ``channel_axis``  the scale-table axis — only 0 (leading-axis rows,
                      the ``lead_axes=1`` rule) is implemented.
    ``min_scale``     calibration clamp for all-zero channels
                      (``Q8_MIN_SCALE`` by default).
    """
    bits: int = 8
    channel_axis: int = 0
    min_scale: float = 1e-12

    def __post_init__(self):
        _require(self.bits == 8,
                 f"QuantSpec.bits must be 8 (the only implemented code "
                 f"width — the paper's datapath is int8), got {self.bits!r}")
        _require(self.channel_axis == 0,
                 f"QuantSpec.channel_axis must be 0 (per-channel scales "
                 f"over the leading axis is the only implemented layout), "
                 f"got {self.channel_axis!r}")
        _finite(self.min_scale, "QuantSpec.min_scale", positive=True)


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """How to run: chunking, the kernel, donation, drive loop, precision.

    ``use_kernel`` routes dampening through the hand-written CUDA kernels
    (their plain PyTorch versions for tensors on the CPU). ``donate``
    defaults to None = NO donation (callers may keep references to the
    pre-edit parameter tree); ``donate=True`` lets the fused steps write the
    edited layers into the caller's tensors. ``sweep_mode`` takes
    "layerwise" in this port so far; the scanned sweep raises a ValueError
    naming the slice that brings it.

    ``precision`` picks the numeric path: ``"fp32"`` (default) or
    ``"int8"`` — int8 weight codes with f32 scale tables, dequant-free
    dampening in the int8 kernel, halting on the fake-quantised weights.
    ``quant`` optionally pins the int8 calibration (a ``QuantSpec``); it may
    only be set when ``precision="int8"`` — a quant table on an fp32
    request is a config contradiction and raises.
    """
    chunk_size: int = 8
    use_kernel: bool = False          # CUDA dampening kernels
    donate: Optional[bool] = None     # None: no donation
    sweep_mode: str = "layerwise"
    precision: str = "fp32"           # "fp32" | "int8"
    quant: Optional[QuantSpec] = None  # int8 calibration (int8 only)

    def __post_init__(self):
        _require(isinstance(self.chunk_size, int)
                 and not isinstance(self.chunk_size, bool)
                 and self.chunk_size >= 1,
                 f"ExecSpec.chunk_size must be an int >= 1, "
                 f"got {self.chunk_size!r}")
        _require(isinstance(self.use_kernel, bool),
                 f"ExecSpec.use_kernel must be a bool, got {self.use_kernel!r}")
        _require(self.donate is None or isinstance(self.donate, bool),
                 f"ExecSpec.donate must be None (no donation) or a bool, "
                 f"got {self.donate!r}")
        check_engine_modes(self.sweep_mode, self.precision, "ExecSpec")
        if isinstance(self.quant, dict):  # convenience: accept mappings
            object.__setattr__(self, "quant",
                               _from_dict(QuantSpec, self.quant, "quant"))
        _require(self.quant is None or isinstance(self.quant, QuantSpec),
                 f"ExecSpec.quant must be None or a QuantSpec (or a mapping "
                 f"of its fields), got {type(self.quant).__name__}")
        _require(self.quant is None or self.precision == "int8",
                 f"ExecSpec.quant is set but precision={self.precision!r}: "
                 f"a quantisation calibration on an fp32 request is a "
                 f'config contradiction — set precision="int8" or drop '
                 f"quant")


@dataclasses.dataclass(frozen=True)
class UnlearnSpec:
    """mode + (DampenSpec, HaltSpec, ExecSpec): one auditable request config.
    ``to_config()`` lowers to the engine-level ``UnlearnConfig`` with the
    reference's mode mapping."""
    mode: str = "ficabu"
    dampen: DampenSpec = DampenSpec()
    halt: HaltSpec = HaltSpec()
    exec: ExecSpec = ExecSpec()

    def __post_init__(self):
        _require(isinstance(self.mode, str) and self.mode in MODES,
                 f"UnlearnSpec.mode must be one of {MODES} — {_MODE_DOC} — "
                 f"got {self.mode!r}")
        for name, cls in (("dampen", DampenSpec), ("halt", HaltSpec),
                          ("exec", ExecSpec)):
            val = getattr(self, name)
            if isinstance(val, dict):  # convenience: accept plain mappings
                object.__setattr__(self, name, _from_dict(cls, val, name))
            else:
                _require(isinstance(val, cls),
                         f"UnlearnSpec.{name} must be a {cls.__name__} "
                         f"(or a mapping of its fields), "
                         f"got {type(val).__name__}")

    # -- constructors -------------------------------------------------------
    @classmethod
    def for_mode(cls, mode: str, *,
                 alpha: float = 10.0, lam: float = 1.0, tau: float = 0.05,
                 checkpoint_every: int = 4, b_r: float = 10.0,
                 c_m: Optional[float] = None, max_layers: Optional[int] = None,
                 chunk_size: int = 8, use_kernel: bool = False,
                 donate: Optional[bool] = None,
                 sweep_mode: str = "layerwise",
                 precision: str = "fp32",
                 quant: Optional[QuantSpec] = None) -> "UnlearnSpec":
        """Flat-kwargs constructor mirroring the reference's."""
        return cls(
            mode=mode,
            dampen=DampenSpec(alpha=alpha, lam=lam, b_r=b_r, c_m=c_m),
            halt=HaltSpec(tau=tau, checkpoint_every=checkpoint_every,
                          max_layers=max_layers),
            exec=ExecSpec(chunk_size=chunk_size, use_kernel=use_kernel,
                          donate=donate, sweep_mode=sweep_mode,
                          precision=precision, quant=quant))

    # -- mode semantics -----------------------------------------------------
    @property
    def cau_enabled(self) -> bool:
        return self.mode in ("cau", "ficabu")

    @property
    def bd_enabled(self) -> bool:
        if self.dampen.balanced is not None:
            return self.dampen.balanced
        return self.mode in ("bd", "ficabu")

    def to_config(self) -> UnlearnConfig:
        """Lower to the engine-level config: CAU off => tau=-1 (never
        early-stop) and checkpoint_every=0 (no checkpoints); BD on/off from
        the mode; the int8 calibration's clamp as ``quant_min_scale``."""
        cau_on = self.cau_enabled
        return UnlearnConfig(
            alpha=self.dampen.alpha, lam=self.dampen.lam,
            tau=self.halt.tau if cau_on else -1.0,
            checkpoint_every=self.halt.checkpoint_every if cau_on else 0,
            balanced=self.bd_enabled, b_r=self.dampen.b_r, c_m=self.dampen.c_m,
            chunk_size=self.exec.chunk_size, use_kernel=self.exec.use_kernel,
            max_layers=self.halt.max_layers,
            sweep_mode=self.exec.sweep_mode,
            precision=self.exec.precision,
            quant_min_scale=(self.exec.quant.min_scale
                             if self.exec.quant is not None else 1e-12))

    # -- JSON round trip ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Any) -> "UnlearnSpec":
        _require(isinstance(d, dict),
                 f"UnlearnSpec.from_dict expects a mapping, "
                 f"got {type(d).__name__}")
        unknown = set(d) - {"mode", "dampen", "halt", "exec"}
        _require(not unknown,
                 f"unknown UnlearnSpec field(s) {sorted(unknown)}; expected "
                 f"a subset of ['mode', 'dampen', 'halt', 'exec']")
        kw: Dict[str, Any] = {}
        if "mode" in d:
            kw["mode"] = d["mode"]
        for name, sub_cls in (("dampen", DampenSpec), ("halt", HaltSpec),
                              ("exec", ExecSpec)):
            if name in d:
                sub = d[name]
                kw[name] = (sub if isinstance(sub, sub_cls)
                            else _from_dict(sub_cls, sub, name))
        return cls(**kw)

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_json(cls, s: str) -> "UnlearnSpec":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise ValueError(f"UnlearnSpec.from_json: not valid JSON: {e}") \
                from e
        return cls.from_dict(d)
