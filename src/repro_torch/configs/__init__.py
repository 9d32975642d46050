"""Architecture registry: the 10 assigned configs, copies of the JAX
package's ``configs/`` (config files are data; serving runs all ten)."""

from repro_torch.configs import (
    command_r_plus_104b,
    minitron_4b,
    deepseek_67b,
    gemma3_12b,
    mamba2_2_7b,
    qwen3_moe_235b_a22b,
    deepseek_v2_lite_16b,
    hymba_1_5b,
    whisper_large_v3,
    llama_3_2_vision_90b,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in [
        command_r_plus_104b,
        minitron_4b,
        deepseek_67b,
        gemma3_12b,
        mamba2_2_7b,
        qwen3_moe_235b_a22b,
        deepseek_v2_lite_16b,
        hymba_1_5b,
        whisper_large_v3,
        llama_3_2_vision_90b,
    ]
}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(ARCHS)}")
    return ARCHS[name]


# (arch, shape) cells skipped in the dry-run, with reasons (DESIGN.md
# §Arch-applicability): long_500k needs sub-quadratic attention.
LONG_CONTEXT_ARCHS = {"mamba2-2.7b", "hymba-1.5b", "gemma3-12b"}

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "pure full attention — O(S^2) at 500k; skipped per spec"
    return True, ""
