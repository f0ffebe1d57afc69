"""Assigned architecture registry — the port of ``repro/configs``:
``get_config(arch_id)`` returns the full-size ArchCfg, ``get_reduced(
arch_id)`` a smoke-test-sized config of the same family (same block
pattern, tiny dims).  Each config is the reference's, built on the port's
``ArchCfg``."""

from importlib import import_module

ARCH_IDS = [
    "h2o_danube3_4b",
    "gemma3_4b",
    "gemma2_27b",
    "llama3_8b",
    "mixtral_8x22b",
    "qwen2_moe_a2_7b",
    "zamba2_2_7b",
    "seamless_m4t_medium",
    "chameleon_34b",
    "xlstm_350m",
]

# external ids (with dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "zamba2-2.7b": "zamba2_2_7b",
})


def _module(arch_id: str):
    name = ALIASES.get(arch_id, arch_id)
    return import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_reduced(arch_id: str):
    return _module(arch_id).reduced_config()
