"""Arch registry: ``--arch <id>`` resolves here (port of
``repro.configs.registry``; the configs are pure data, copied)."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.base import ArchSpec
from repro_torch.optim.adamw import AdamWConfig

from repro_torch.configs import (phi35_moe_42b, grok1_314b, stablelm_12b,
                                 codeqwen15_7b, mistral_large_123b, gatedgcn,
                                 gin_tu, meshgraphnet, graphsage_reddit,
                                 dlrm_mlperf)

_MODULES = (phi35_moe_42b, grok1_314b, stablelm_12b, codeqwen15_7b,
            mistral_large_123b, gatedgcn, gin_tu, meshgraphnet,
            graphsage_reddit, dlrm_mlperf)

ARCHS: Dict[str, ArchSpec] = {m.SPEC.arch_id: m.SPEC for m in _MODULES}
OPTS: Dict[str, AdamWConfig] = {m.SPEC.arch_id: m.OPT for m in _MODULES}
SMOKES = {m.SPEC.arch_id: m.SMOKE for m in _MODULES}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_opt(arch_id: str) -> AdamWConfig:
    return OPTS[arch_id]


def all_cells() -> Tuple[Tuple[str, str], ...]:
    """All 40 (arch, shape) dry-run cells."""
    out = []
    for aid, spec in ARCHS.items():
        for sh in spec.shapes:
            out.append((aid, sh.name))
    return tuple(out)
