"""Public unlearning API: typed specs + the ``Unlearner`` facade.

    from repro_torch.api import Unlearner, UnlearnSpec, ForgetRequest

    spec = UnlearnSpec.for_mode("ficabu", alpha=10.0, tau=0.2, use_kernel=True)
    unl = Unlearner(adapter, fisher_global, spec, device="cuda")
    params, stats = unl.forget(ForgetRequest(fx, fy), params=params)
"""
from .facade import ForgetRequest, Unlearner  # noqa: F401
from .specs import (MODES, DampenSpec, ExecSpec, HaltSpec,  # noqa: F401
                    QuantSpec, UnlearnSpec)
