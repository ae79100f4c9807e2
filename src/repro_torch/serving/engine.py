"""Wave-batched serving engine.

Port of ``repro/serving/engine.py``.  Requests are served in fixed-shape
*waves* of ``wave_size`` (the last wave padded with ``[0]`` prompts): each
wave left-pads its prompts to ``prompt_len`` with token 0 (no mask, as
the reference), runs one prefill, then a greedy or sampled decode loop on
the shared KV cache at positions ``prompt_len + i``.  A request stops at
its ``max_new_tokens`` or at its ``eos_id`` (kept in its output); the wave
runs until its longest request is done or every request has hit its eos.
An ``audio`` model's wave also carries zero source frames
(wave, ``prompt_len``, d_model), and its decode starts at position 1:
the prefill decoded the prompt's first token at 0, as in the reference.
The port runs eagerly on ``device`` and draws samples from ``generator``
(the reference's ``seed``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampler import SamplerConfig, sample


@dataclasses.dataclass
class ServeRequest:
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None


@dataclasses.dataclass
class ServeResult:
    tokens: list[int]


class ServeEngine:
    def __init__(self, model, params, cfg: ModelConfig, *, wave_size: int = 4,
                 prompt_len: int = 16, sampler: SamplerConfig | None = None,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        self.model, self.params, self.cfg = model, params, cfg
        self.wave_size, self.prompt_len = wave_size, prompt_len
        self.sampler = sampler if sampler is not None else SamplerConfig()
        self.device = resolve_device(device)
        self.generator = generator if generator is not None else \
            torch.Generator(self.device.type).manual_seed(0)

    # -- queue -----------------------------------------------------------
    def serve(self, requests: Sequence[ServeRequest]) -> list[ServeResult]:
        out: list[ServeResult] = []
        for start in range(0, len(requests), self.wave_size):
            wave = list(requests[start:start + self.wave_size])
            n_real = len(wave)
            while len(wave) < self.wave_size:       # pad the last wave
                wave.append(ServeRequest(prompt=[0], max_new_tokens=1))
            out.extend(self._serve_wave(wave)[:n_real])
        return out

    def _pad_prompt(self, p: list[int]) -> list[int]:
        p = p[-self.prompt_len:]
        return [0] * (self.prompt_len - len(p)) + p

    def _serve_wave(self, wave: list[ServeRequest]) -> list[ServeResult]:
        tokens = torch.tensor([self._pad_prompt(r.prompt) for r in wave],
                              dtype=torch.int32, device=self.device)
        batch = {"tokens": tokens}
        if self.cfg.family == "audio":
            batch["src_embeds"] = torch.zeros(
                (len(wave), self.prompt_len, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        logits, cache = self.model.prefill(self.params, batch)

        max_new = max(r.max_new_tokens for r in wave)
        start_pos = self.prompt_len if self.cfg.family != "audio" else 1
        results = [[] for _ in wave]
        done = np.zeros(len(wave), bool)
        for i in range(max_new):
            tok = sample(self.generator, logits[:, -1, :],
                         self.sampler)[:, None]
            step_tokens = tok[:, 0].cpu().numpy()
            for b, r in enumerate(wave):
                if done[b] or i >= r.max_new_tokens:
                    continue
                t = int(step_tokens[b])
                results[b].append(t)
                if r.eos_id is not None and t == r.eos_id:
                    done[b] = True
            if done.all() or i == max_new - 1:
                break
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   start_pos + i)
        return [ServeResult(tokens=r) for r in results]
