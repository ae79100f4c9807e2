"""The LM serving path on a card (``cuda``-marked; skips without one).

Kept apart from ``tests/test_torch_lm_serving.py`` so that it imports no
JAX: on the card the port is held against its own plain path on the CPU.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.serving import ServeEngine, ServeRequest


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b", "zamba2-2.7b"])
def test_cuda_serve_engine_kernel_path_equals_the_cpu_plain_path(arch):
    """f32 parameters, 32-token prompts with the flash and SSD kernel
    switches on (``configs.for_device``): the greedy tokens on the card
    equal the CPU's plain path, and the prefill launched the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import attention, ssd

    cfg = dataclasses.replace(tconfigs.smoke(tconfigs.get_config(arch)),
                              param_dtype=torch.float32, flash_threshold=16,
                              flash_block=16)
    p = tbuild(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    reqs = [ServeRequest(prompt=list(range(1, 40)), max_new_tokens=6),
            ServeRequest(prompt=[7, 8, 9], max_new_tokens=4)]

    def serve(dev):
        c = tconfigs.for_device(cfg, dev)
        eng = ServeEngine(tbuild(c), _to(p, dev), c, wave_size=2,
                          prompt_len=32, device=dev)
        return [r.tokens for r in eng.serve(reqs)]

    want = serve("cpu")
    attention.reset_launches()
    ssd.reset_launches()
    got = serve("cuda")
    assert got == want
    n_attn = sum(k != "mamba" for k in cfg.pattern) * cfg.n_repeats
    n_mamba = sum(k == "mamba" for k in cfg.pattern) * cfg.n_repeats
    assert attention.LAUNCHES["flash_attention"] == n_attn
    assert ssd.LAUNCHES["ssd_intra"] == n_mamba
