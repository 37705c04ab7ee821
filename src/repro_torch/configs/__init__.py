"""Architecture registry: the 10 assigned configs + smoke variants, and
the one-card served cuts of Jamba (``jamba-1.5-large``) and Mixtral
(``mixtral-8x7b-ep2``)."""
from __future__ import annotations

from .base import ModelConfig, ShapeConfig, TrainConfig, SHAPES

from .yi_9b import FULL as YI_9B, smoke as yi_9b_smoke
from .minicpm3_4b import FULL as MINICPM3_4B, smoke as minicpm3_4b_smoke
from .llama3_2_3b import FULL as LLAMA3_2_3B, smoke as llama3_2_3b_smoke
from .qwen1_5_0_5b import FULL as QWEN1_5_0_5B, smoke as qwen1_5_0_5b_smoke
from .internvl2_76b import FULL as INTERNVL2_76B, smoke as internvl2_76b_smoke
from .llama4_maverick import FULL as LLAMA4_MAVERICK, smoke as llama4_maverick_smoke
from .mixtral_8x7b import FULL as MIXTRAL_8X7B, smoke as mixtral_8x7b_smoke
from .mixtral_8x7b import SERVED as MIXTRAL_8X7B_SERVED
from .whisper_tiny import FULL as WHISPER_TINY, smoke as whisper_tiny_smoke
from .jamba_1_5_large import FULL as JAMBA_1_5_LARGE, smoke as jamba_1_5_large_smoke
from .jamba_1_5_large import SERVED as JAMBA_1_5_LARGE_SERVED
from .xlstm_350m import FULL as XLSTM_350M, smoke as xlstm_350m_smoke

REGISTRY: dict[str, ModelConfig] = {
    "yi-9b": YI_9B,
    "minicpm3-4b": MINICPM3_4B,
    "llama3.2-3b": LLAMA3_2_3B,
    "qwen1.5-0.5b": QWEN1_5_0_5B,
    "internvl2-76b": INTERNVL2_76B,
    "llama4-maverick-400b-a17b": LLAMA4_MAVERICK,
    "mixtral-8x7b": MIXTRAL_8X7B,
    "whisper-tiny": WHISPER_TINY,
    "jamba-1.5-large-398b": JAMBA_1_5_LARGE,
    "xlstm-350m": XLSTM_350M,
    # one supercell holding 8 of 16 experts: what one card serves
    "jamba-1.5-large": JAMBA_1_5_LARGE_SERVED,
    # every layer at full width holding 4 of 8 experts: card 0 of two
    "mixtral-8x7b-ep2": MIXTRAL_8X7B_SERVED,
}

SMOKE: dict[str, ModelConfig] = {
    "yi-9b": yi_9b_smoke(),
    "minicpm3-4b": minicpm3_4b_smoke(),
    "llama3.2-3b": llama3_2_3b_smoke(),
    "qwen1.5-0.5b": qwen1_5_0_5b_smoke(),
    "internvl2-76b": internvl2_76b_smoke(),
    "llama4-maverick-400b-a17b": llama4_maverick_smoke(),
    "mixtral-8x7b": mixtral_8x7b_smoke(),
    "whisper-tiny": whisper_tiny_smoke(),
    "jamba-1.5-large-398b": jamba_1_5_large_smoke(),
    "xlstm-350m": xlstm_350m_smoke(),
    "jamba-1.5-large": jamba_1_5_large_smoke(),
    "mixtral-8x7b-ep2": mixtral_8x7b_smoke(),
}

# archs whose `long_500k` cell runs (sub-quadratic sequence mixing);
# all others skip it (DESIGN.md §4)
LONG_CONTEXT_ARCHS = {"jamba-1.5-large-398b", "xlstm-350m", "mixtral-8x7b"}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    reg = SMOKE if smoke else REGISTRY
    if arch not in reg:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(reg)}")
    return reg[arch]


def shape_cells(arch: str) -> list[str]:
    """The shape grid for one arch (long_500k only for sub-quadratic)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells
