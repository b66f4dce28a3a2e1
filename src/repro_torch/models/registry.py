"""Model registry: LM families -> unified model API, SR models -> specs.

LM side — ``get_model(cfg)`` returns the family's module, which exposes:
  schema(cfg)                          parameter ParamSpec tree
  cache_schema(cfg, batch, max_len)    decode-cache ParamSpec tree (encdec
                                       also takes ``enc_len``)
  loss(params, cfg, batch)             -> (scalar loss, metrics)
  prefill(params, cfg, batch, cache)   -> (last logits (B,V), cache)
  decode_step(params, cfg, tok, cache, pos) -> (logits (B,V), cache)
The dense, vlm and moe families are ``models.lm``, ssm is
``models.mamba_lm``, hybrid ``models.zamba`` and encdec ``models.encdec``.

SR side — a registered :class:`SRModelSpec` (canonical name, config, weight
initialiser) is how ``repro_torch.engine.SRSession.open("abpn_x3")``
resolves a model name into a servable conv stack without the caller
touching plans or weights.  Two are registered: ``abpn_x3`` (a
``ConvLayer`` chain) and ``rlfn_x4`` (a ``core.stages.StagedModel``).
"""

from __future__ import annotations

import dataclasses
import difflib
import functools
import types
from typing import Callable, Dict, Sequence, Tuple, Union

from repro_torch.models import encdec, lm, mamba_lm, zamba
from repro_torch.models.abpn import ABPNConfig, init_abpn
from repro_torch.models.rlfn import RLFNConfig, init_rlfn, rlfn_model

__all__ = [
    "get_model",
    "get_sr_model",
    "list_sr_models",
    "register_sr_model",
    "SRModelSpec",
]

_FAMILY = {
    "dense": lm,
    "moe": lm,
    "vlm": lm,
    "ssm": mamba_lm,
    "hybrid": zamba,
    "encdec": encdec,
}


def get_model(cfg) -> types.ModuleType:
    if cfg.family in _FAMILY:
        return _FAMILY[cfg.family]
    raise ValueError(f"unknown family {cfg.family!r}; expected one of {sorted(_FAMILY)}")


# ----------------------------------------------------------------------
# SR models (served through repro_torch.engine.SRSession)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SRModelSpec:
    """A servable SR model.

    ``config`` carries at least ``scale`` and ``clip`` (the session's
    epilogue defaults); ``init(generator)`` produces the weight stack, a
    ``Sequence[ConvLayer]`` or a ``core.stages.StagedModel`` (a trained
    stack can be passed to ``SRSession.open`` directly instead).
    """

    name: str
    config: Union[ABPNConfig, RLFNConfig]
    init: Callable[..., Sequence]


_SR_MODELS: Dict[str, SRModelSpec] = {}


def register_sr_model(
    name: str,
    config,
    init: Callable[..., Sequence],
    aliases: Tuple[str, ...] = (),
) -> SRModelSpec:
    """Register an SR model under ``name`` (plus aliases)."""
    spec = SRModelSpec(name=name, config=config, init=init)
    names = (name, *aliases)
    taken = [n for n in names if n in _SR_MODELS]
    if taken:  # reject up front — a failed call must not half-register
        raise ValueError(f"SR model name(s) already registered: {taken}")
    for n in names:
        _SR_MODELS[n] = spec
    return spec


def list_sr_models() -> Tuple[str, ...]:
    """Canonical names of every registered SR model (aliases excluded)."""
    return tuple(sorted({s.name for s in _SR_MODELS.values()}))


def get_sr_model(name: str) -> SRModelSpec:
    try:
        return _SR_MODELS[name]
    except KeyError:
        known = sorted(_SR_MODELS)
        close = difflib.get_close_matches(str(name), known, n=1)
        hint = f" (did you mean {close[0]!r}?)" if close else ""
        raise ValueError(
            f"unknown SR model {name!r}{hint}; registered: "
            f"{list(list_sr_models())}, aliases included: {known}"
        ) from None


# The paper's model: ABPN x3.
register_sr_model(
    "abpn_x3",
    ABPNConfig(),
    functools.partial(init_abpn, cfg=ABPNConfig()),
    aliases=("abpn-x3", "abpn"),
)


def _init_rlfn_model(generator, cfg: RLFNConfig = RLFNConfig()):
    return rlfn_model(init_rlfn(generator, cfg), cfg)


# RLFN x4 (Kong et al., CVPRW 2022): residual blocks with ESA, no anchor.
register_sr_model(
    "rlfn_x4",
    RLFNConfig(),
    functools.partial(_init_rlfn_model, cfg=RLFNConfig()),
    aliases=("rlfn-x4", "rlfn"),
)
