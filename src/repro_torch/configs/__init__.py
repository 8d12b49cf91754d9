"""Config registry: ``--arch <id>`` resolution.

ARCHS maps the assigned architecture ids to their config modules; each
module exports CONFIG (exact public-literature hyperparameters) and
smoke_config() (reduced same-family config for CPU tests)."""

import importlib

ARCHS = {
    "qwen2.5-3b": "repro_torch.configs.qwen25_3b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "schnet": "repro_torch.configs.schnet",
    "bst": "repro_torch.configs.bst",
    "din": "repro_torch.configs.din",
    "wide-deep": "repro_torch.configs.wide_deep",
    "dien": "repro_torch.configs.dien",
}


def get_module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str, shape: str | None = None):
    mod = get_module(arch)
    if shape is not None and hasattr(mod, "config_for_shape"):
        return mod.config_for_shape(shape)
    return mod.CONFIG


def get_smoke_config(arch: str):
    return get_module(arch).smoke_config()


def all_archs():
    return list(ARCHS)
