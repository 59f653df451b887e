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
                  buffer donation, the drive loop, the numeric path (with
                  ``QuantSpec``, the int8 calibration) and the drain guard
                  (``repro_torch.robust.GuardSpec``).

A fourth, optional concern — ``RefreshSpec`` — schedules the streamed
global-Fisher refresh (``repro_torch.engine.fisher_stream``).

``UnlearnSpec`` composes them under a paper ``mode`` ("ssd" | "cau" |
"bd" | "ficabu"): JSON round-trip via ``to_json``/``from_json`` (the same
JSON as the reference's, read by either package), validation that raises
``ValueError`` with actionable messages, and ``to_config()`` lowering to
the engine-level ``core.cau.UnlearnConfig`` with the reference's mode
mapping. ``ServeSpec`` is the serving deployment's configuration and lowers
to an ``UnlearnSpec``.

Not ported yet: mesh placement (``ExecSpec.mesh_axes``) and the persistent
compilation cache (``ExecSpec.cache_dir`` / ``ServeSpec.cache_dir``), the
ROADMAP Queue 1 items "Distribution" and "The persistent compilation
cache". The fields exist so that the reference's JSON reads here; a value
other than None raises.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.cau import PRECISIONS, SWEEP_MODES, UnlearnConfig
from repro_torch.robust.guards import GuardSpec

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


# ROADMAP Queue 1's items, by title (a number would go stale when the
# queue is renumbered)
MESH_ITEM = "Distribution"
CACHE_ITEM = "The persistent compilation cache"


def _not_ported(what: str, item: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP Queue 1, item "
                      f"{item!r})")


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
class RefreshSpec:
    """When to refresh the global Fisher I_D between drains (and how hard).

    The stored I_D describes the weights it was computed on; every forget
    drain edits the served parameters, so I_D goes stale and the dampening
    ratio I_Df/I_D drifts.  A ``RefreshSpec`` schedules the streamed EMA
    refresh (``repro_torch.engine.fisher_stream``, DESIGN.md §10):

    ``every_drains``        refresh after every N-th drain (0: cadence off,
                            staleness trigger only).
    ``staleness_threshold`` refresh once this fraction of parameters was
                            edited since the last refresh (0: off).
    ``max_batches``         retain microbatches folded per refresh — the
                            budget a drain point may spend.
    ``decay``               EMA retention: 0 replaces I_D with the fresh
                            microbatch Fisher, 1 disables the update.
    """
    every_drains: int = 1
    staleness_threshold: float = 0.0
    max_batches: int = 1
    decay: float = 0.9

    def __post_init__(self):
        # one source of truth for the bounds: validate by lowering to the
        # engine-level policy, rephrasing its errors in this spec's words
        try:
            self.to_policy()
        except ValueError as e:
            raise ValueError(
                str(e).replace("RefreshPolicy", "RefreshSpec")) from None

    def to_policy(self):
        """Lower to the engine-level ``RefreshPolicy``."""
        from repro_torch.engine.fisher_stream import RefreshPolicy
        return RefreshPolicy(every_drains=self.every_drains,
                             staleness_threshold=self.staleness_threshold,
                             max_batches=self.max_batches, decay=self.decay)


_SHARDING_MODES = ("tp", "fsdp")
_PUBLISH_MODES = ("immediate", "step")


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
    edited layers into the caller's tensors (coalesced group sweeps never
    donate: the snapshot must survive the drain).

    ``sweep_mode`` picks the engine's drive loop: ``"layerwise"`` (the
    host-driven per-layer oracle) or ``"scanned"`` — the whole
    back-end-first sweep as ONE cached program with on-device halting
    (``repro_torch.engine.sweep``); shape-heterogeneous stacks (ResNet) fall
    back to the layerwise driver automatically, so ``"scanned"`` is always
    safe to request.

    ``precision`` picks the numeric path: ``"fp32"`` (default) or
    ``"int8"`` — int8 weight codes with f32 scale tables, dequant-free
    dampening in the int8 kernel, halting on the fake-quantised weights.
    ``quant`` optionally pins the int8 calibration (a ``QuantSpec``); it may
    only be set when ``precision="int8"`` — a quant table on an fp32
    request is a config contradiction and raises.

    ``guard`` (a ``repro_torch.robust.GuardSpec``) validates a drain's
    edited tree before the fleet may publish it. ``mesh_axes`` and
    ``cache_dir`` are not ported yet (ROADMAP Queue 1, items
    "Distribution" and "The persistent compilation cache"): None only;
    ``sharding`` names the reference's layout rule and is inert without a
    mesh.
    """
    chunk_size: int = 8
    use_kernel: bool = False          # CUDA dampening kernels
    donate: Optional[bool] = None     # None: no donation
    mesh_axes: Optional[Tuple[str, ...]] = None  # not ported yet
    sharding: str = "tp"              # the reference's layout rule
    cache_dir: Optional[str] = None   # not ported yet
    sweep_mode: str = "layerwise"     # "layerwise" | "scanned"
    precision: str = "fp32"           # "fp32" | "int8"
    quant: Optional[QuantSpec] = None  # int8 calibration (int8 only)
    # pre-publication drain guard: a drain whose edited tree fails
    # validation is discarded and retried/dead-lettered by the fleet
    guard: Optional[GuardSpec] = None

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
        if self.mesh_axes is not None:
            raise _not_ported("ExecSpec.mesh_axes (mesh placement)",
                              MESH_ITEM)
        _require(self.sharding in _SHARDING_MODES,
                 f"ExecSpec.sharding must be one of {_SHARDING_MODES}, "
                 f"got {self.sharding!r}")
        _require(self.cache_dir is None or
                 (isinstance(self.cache_dir, str) and self.cache_dir),
                 f"ExecSpec.cache_dir must be None or a non-empty path, "
                 f"got {self.cache_dir!r}")
        if self.cache_dir is not None:
            raise _not_ported("ExecSpec.cache_dir (the persistent "
                              "compilation cache)", CACHE_ITEM)
        _require(self.sweep_mode in SWEEP_MODES,
                 f"ExecSpec.sweep_mode must be one of {SWEEP_MODES} "
                 f'("scanned" lowers the whole sweep as one compiled '
                 f'program where the stack allows it), '
                 f"got {self.sweep_mode!r}")
        _require(self.precision in PRECISIONS,
                 f"ExecSpec.precision must be one of {PRECISIONS} "
                 f'("int8" routes through the quantised program family), '
                 f"got {self.precision!r}")
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
        if isinstance(self.guard, dict):  # convenience: accept mappings
            object.__setattr__(self, "guard", GuardSpec.from_dict(self.guard))
        _require(self.guard is None or isinstance(self.guard, GuardSpec),
                 f"ExecSpec.guard must be None or a "
                 f"repro_torch.robust.GuardSpec (or a mapping of its fields), "
                 f"got {type(self.guard).__name__}")


@dataclasses.dataclass(frozen=True)
class UnlearnSpec:
    """mode + (DampenSpec, HaltSpec, ExecSpec), and an optional
    RefreshSpec: one auditable request config. ``to_config()`` lowers to
    the engine-level ``UnlearnConfig`` with the reference's mode mapping."""
    mode: str = "ficabu"
    dampen: DampenSpec = DampenSpec()
    halt: HaltSpec = HaltSpec()
    exec: ExecSpec = ExecSpec()
    refresh: Optional[RefreshSpec] = None  # None: I_D stays frozen (SSD)

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
        if isinstance(self.refresh, dict):
            object.__setattr__(self, "refresh",
                               _from_dict(RefreshSpec, self.refresh,
                                          "refresh"))
        else:
            _require(self.refresh is None
                     or isinstance(self.refresh, RefreshSpec),
                     f"UnlearnSpec.refresh must be None (no streamed "
                     f"refresh), a RefreshSpec, or a mapping of its fields, "
                     f"got {type(self.refresh).__name__}")

    # -- constructors -------------------------------------------------------
    @classmethod
    def for_mode(cls, mode: str, *,
                 alpha: float = 10.0, lam: float = 1.0, tau: float = 0.05,
                 checkpoint_every: int = 4, b_r: float = 10.0,
                 c_m: Optional[float] = None, max_layers: Optional[int] = None,
                 chunk_size: int = 8, use_kernel: bool = False,
                 donate: Optional[bool] = None,
                 cache_dir: Optional[str] = None,
                 sweep_mode: str = "layerwise",
                 precision: str = "fp32",
                 quant: Optional[QuantSpec] = None,
                 guard: Optional[GuardSpec] = None,
                 refresh: Optional[RefreshSpec] = None) -> "UnlearnSpec":
        """Flat-kwargs constructor mirroring the reference's."""
        return cls(
            mode=mode,
            dampen=DampenSpec(alpha=alpha, lam=lam, b_r=b_r, c_m=c_m),
            halt=HaltSpec(tau=tau, checkpoint_every=checkpoint_every,
                          max_layers=max_layers),
            exec=ExecSpec(chunk_size=chunk_size, use_kernel=use_kernel,
                          donate=donate, cache_dir=cache_dir,
                          sweep_mode=sweep_mode, precision=precision,
                          quant=quant, guard=guard),
            refresh=refresh)

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
        unknown = set(d) - {"mode", "dampen", "halt", "exec", "refresh"}
        _require(not unknown,
                 f"unknown UnlearnSpec field(s) {sorted(unknown)}; expected "
                 f"a subset of ['mode', 'dampen', 'halt', 'exec', "
                 f"'refresh']")
        kw: Dict[str, Any] = {}
        if "mode" in d:
            kw["mode"] = d["mode"]
        for name, sub_cls in (("dampen", DampenSpec), ("halt", HaltSpec),
                              ("exec", ExecSpec)):
            if name in d:
                sub = d[name]
                kw[name] = (sub if isinstance(sub, sub_cls)
                            else _from_dict(sub_cls, sub, name))
        if "refresh" in d:
            sub = d["refresh"]
            kw["refresh"] = (sub if sub is None or isinstance(sub, RefreshSpec)
                             else _from_dict(RefreshSpec, sub, "refresh"))
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


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """The serving deployment's configuration — ONE frozen, auditable spec
    consumed by both the single-tenant ``serve.py`` path and the fleet
    (``repro_torch.fleet``), replacing ``ForgetService``'s positional-argument
    signature and its ``CHUNK`` class constant (port of the reference's).

    ``chunk_size``      Fisher/engine gradient chunking; forget batches are
                        padded (never trimmed) to a multiple of it.
    ``coalesce``        union all forget requests due at a drain point into
                        ONE engine sweep (the serving default); False drains
                        one request per sweep (the sequential baseline).
    ``refresh_every``   arm the streamed global-Fisher refresh every N
                        drains (0 = keep the one-shot I_D).
    ``sweep_mode``      engine drive loop ("scanned" megaprogram default).
    ``precision``       numeric path ("fp32" | "int8" program family).
    ``cache_dir``       the persistent compilation cache: not ported yet
                        (ROADMAP Queue 1, "The persistent compilation
                        cache") — None only.
    ``max_forget_samples``  per-request forget-batch cap (the serving
                        harness slices each domain's forget split to this).
    ``publish``         how a drain's edits reach the served weights:
                        ``"immediate"`` (the historical in-place semantics —
                        ``Fleet.drain`` installs the swept tree before
                        returning, bit-identical to every pre-existing
                        caller) or ``"step"`` — the sweep runs against a
                        SHADOW copy of the live tree and the result is
                        STAGED; publication is an atomic pointer swap the
                        serving engine performs only between decode steps
                        (``TenantRuntime.publish_staged``), so a decode
                        step can never observe a half-edited tree.
    ``max_batch``       continuous-batching decode slot-pool width (the
                        stream engine's fixed [B] decode batch,
                        ``launch.serve.StreamEngine``).
    ``admit_chunk``     max sequences admitted per engine step; admission
                        prefills a fixed-width sub-batch of this size (one
                        compiled prefill/scatter program for every
                        admission, padding rows dropped).
    ``publish_lag``     steps between firing a drain and its deadline
                        publication: the engine joins the background sweep
                        and swaps pointers exactly ``publish_lag`` steps
                        after the drain fired, making the publication step
                        — and with it the telemetry event stream —
                        deterministic regardless of sweep-thread timing.

    JSON round-trip via ``to_json``/``from_json``; validation raises
    ``ValueError`` with actionable messages, never ``assert`` — the same
    discipline as ``UnlearnSpec``.  ``to_unlearn_spec()`` lowers to the
    deployment's engine-facing ``UnlearnSpec`` (the mapping previously
    hardcoded in ``serve.default_serve_spec``).
    """
    chunk_size: int = 4
    coalesce: bool = True
    refresh_every: int = 0
    sweep_mode: str = "scanned"
    precision: str = "fp32"
    cache_dir: Optional[str] = None
    max_forget_samples: int = 8
    publish: str = "immediate"
    max_batch: int = 8
    admit_chunk: int = 4
    publish_lag: int = 16
    # pre-publication drain guard (repro_torch.robust.GuardSpec), threaded into
    # the lowered UnlearnSpec's ExecSpec — see ``FleetSpec.guard`` for the
    # fleet-wide default
    guard: Optional[GuardSpec] = None

    def __post_init__(self):
        _require(isinstance(self.chunk_size, int)
                 and not isinstance(self.chunk_size, bool)
                 and self.chunk_size >= 1,
                 f"ServeSpec.chunk_size must be an int >= 1, "
                 f"got {self.chunk_size!r}")
        _require(isinstance(self.coalesce, bool),
                 f"ServeSpec.coalesce must be a bool, got {self.coalesce!r}")
        _require(isinstance(self.refresh_every, int)
                 and not isinstance(self.refresh_every, bool)
                 and self.refresh_every >= 0,
                 f"ServeSpec.refresh_every must be an int >= 0 (0 keeps the "
                 f"one-shot I_D), got {self.refresh_every!r}")
        _require(self.sweep_mode in SWEEP_MODES,
                 f"ServeSpec.sweep_mode must be one of {SWEEP_MODES}, "
                 f"got {self.sweep_mode!r}")
        _require(self.precision in PRECISIONS,
                 f"ServeSpec.precision must be one of {PRECISIONS}, "
                 f"got {self.precision!r}")
        _require(self.cache_dir is None
                 or (isinstance(self.cache_dir, str) and self.cache_dir),
                 f"ServeSpec.cache_dir must be None or a non-empty path, "
                 f"got {self.cache_dir!r}")
        if self.cache_dir is not None:
            raise _not_ported("ServeSpec.cache_dir (the persistent "
                              "compilation cache)", CACHE_ITEM)
        _require(isinstance(self.max_forget_samples, int)
                 and not isinstance(self.max_forget_samples, bool)
                 and self.max_forget_samples >= 1,
                 f"ServeSpec.max_forget_samples must be an int >= 1, "
                 f"got {self.max_forget_samples!r}")
        _require(self.publish in _PUBLISH_MODES,
                 f"ServeSpec.publish must be one of {_PUBLISH_MODES} "
                 f'("immediate" installs a drain\'s edits in place, "step" '
                 f"stages them for an atomic between-steps pointer swap), "
                 f"got {self.publish!r}")
        _require(isinstance(self.max_batch, int)
                 and not isinstance(self.max_batch, bool)
                 and self.max_batch >= 1,
                 f"ServeSpec.max_batch must be an int >= 1 (the decode "
                 f"slot-pool width), got {self.max_batch!r}")
        _require(isinstance(self.admit_chunk, int)
                 and not isinstance(self.admit_chunk, bool)
                 and 1 <= self.admit_chunk,
                 f"ServeSpec.admit_chunk must be an int >= 1, "
                 f"got {self.admit_chunk!r}")
        _require(self.admit_chunk <= self.max_batch,
                 f"ServeSpec.admit_chunk ({self.admit_chunk}) cannot exceed "
                 f"max_batch ({self.max_batch}) — an admission sub-batch "
                 f"scatters into free pool slots")
        _require(isinstance(self.publish_lag, int)
                 and not isinstance(self.publish_lag, bool)
                 and self.publish_lag >= 1,
                 f"ServeSpec.publish_lag must be an int >= 1 step "
                 f"(publication is always between decode steps), "
                 f"got {self.publish_lag!r}")
        if isinstance(self.guard, dict):
            object.__setattr__(self, "guard", GuardSpec.from_dict(self.guard))
        _require(self.guard is None or isinstance(self.guard, GuardSpec),
                 f"ServeSpec.guard must be None or a "
                 f"repro_torch.robust.GuardSpec (or a mapping of its fields), "
                 f"got {type(self.guard).__name__}")

    def to_unlearn_spec(self) -> "UnlearnSpec":
        """Lower to the deployment's engine-facing ``UnlearnSpec`` — the
        exact mapping the legacy ``serve.default_serve_spec`` hardcoded
        (alpha/tau/checkpoint cadence pinned for the serving smoke lane;
        ``refresh_every > 0`` arms a 2-microbatch, decay-0.5 EMA refresh)."""
        refresh = (RefreshSpec(every_drains=self.refresh_every,
                               max_batches=2, decay=0.5)
                   if self.refresh_every > 0 else None)
        return UnlearnSpec.for_mode(
            "ficabu", alpha=8.0, lam=1.0, tau=0.6, checkpoint_every=2,
            chunk_size=self.chunk_size, cache_dir=self.cache_dir,
            sweep_mode=self.sweep_mode, precision=self.precision,
            guard=self.guard, refresh=refresh)

    # -- JSON round trip ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Any) -> "ServeSpec":
        return _from_dict(cls, d, "ServeSpec")

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_json(cls, s: str) -> "ServeSpec":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise ValueError(f"ServeSpec.from_json: not valid JSON: {e}") \
                from e
        return cls.from_dict(d)
