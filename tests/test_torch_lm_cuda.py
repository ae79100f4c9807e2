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


@pytest.mark.cuda
def test_cuda_encdec_kernel_path_equals_the_cpu_plain_path():
    """smoke(seamless-m4t-medium) with a second decoder layer, f32: the
    prefill (32 source frames, one token, an 8-slot self cache) and 6
    greedy decode steps on the card with the flash kernel on, against the
    CPU's plain path; then the feature hook on 32 frames and 32 tokens,
    which runs the kernel in all three of its uses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import attention

    cfg = dataclasses.replace(
        tconfigs.smoke(tconfigs.get_config("seamless-m4t-medium")),
        n_layers=2, param_dtype=torch.float32, flash_threshold=16,
        flash_block=16)
    p = tbuild(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(2)
    src = torch.randn(2, 32, cfg.d_model, generator=g)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g,
                           dtype=torch.int32)

    def run(dev):
        c = tconfigs.for_device(cfg, dev)
        m, params = tbuild(c), _to(p, dev)
        logits, cache = m.prefill(params, {
            "src_embeds": src.to(dev), "tokens": tokens[:, :1].to(dev),
            "decode_len": 8})
        first, toks = logits.cpu(), []
        for i in range(6):
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            toks.append(tok.cpu())
            logits, cache = m.decode_step(params, cache, tok, 1 + i)
        h = m.hidden_states(params, {"src_embeds": src.to(dev),
                                     "tokens": tokens.to(dev)})
        return first, torch.cat(toks, 1), h.cpu()

    want = run("cpu")
    attention.reset_launches()
    got = run("cuda")
    # Encoder layers at the prefill; encoder, decoder self and cross at
    # the feature hook.
    assert attention.LAUNCHES["flash_attention"] == \
        2 * cfg.n_encoder_layers + 2 * cfg.n_layers
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=2e-4 * float(b.abs().max()))
    assert torch.equal(got[1], want[1])
