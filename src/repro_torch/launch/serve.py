"""Batched serving engine: static batching over the decode paths of every family.

The port of `repro.launch.serve`:

    server = BatchServer(cfg, params, ServeConfig(max_batch=8, cache_len=1024))
    outputs = server.generate(prompts, max_new_tokens=32)

Requests are grouped into batches of `max_batch`, prompts LEFT-padded with
`pad_token` to a common length (pad tokens are attended, as in the
reference), fed through `decode_step` token by token (prefill is decode with
teacher forcing), then decoded greedily or by temperature sampling.  On the
card every token goes through the decode-attention kernel (K5) in the dense
family; in the hybrid family through K5 at each attention site and every
Mamba-2 layer's one-step recurrence (plain PyTorch, as in the reference),
not through the scan kernel K6; in the ssm family (rwkv6) through the WKV
scan kernel K7 with T = 1 in every time-mix layer, from the carried state
(the family's cache is that state and ignores ``cache_len`` and
``cache_dtype``); in the moe family through K5 at every layer, the router
and every expert run as the reference runs them at one token (a capacity
of 1 a row: each step reads every routed expert's weights).  The audio
family (seamless-m4t) takes ``generate(..., frames=)``, one (F, d_model)
row of frame embeddings a prompt: each group's cache is built from its
frames (the encoder runs once, K4, and fills the cross cache, cast to
``cache_dtype`` after its projection), and every decode step runs K5 twice
a decoder layer, over the token cache and over the cross cache.  The vlm
family (internvl2) serves as the dense family does, as the reference's
server does: text prompts, K5 at every layer a step, no patches.

With ``quantize=True`` the server quantizes the weights once, at
construction (`repro_torch.quant.quantize_params`: int8 with per-channel
float32 scales), and every step dequantises one layer's matrix at a time
just before its product; the tree on the card is about half the bf16 one.

Differences from the reference: the KV cache (and the ssm state) is written in place
(``k_cache[:, slot] = k``) instead of by `dynamic_update_slice`; temperature
sampling draws from a `torch.Generator` instead of a jax key.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.quant import quantize_params
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    cache_len: int = 512
    quantize: bool = False
    temperature: float = 0.0  # 0 = greedy
    pad_token: int = 0
    cache_dtype: str = "float32"


class BatchServer:
    """Serves ``cfg`` with ``params`` (already on ``device``, default CUDA;
    a bf16 / float32 tree, or with ``quantize`` one that is quantized here)."""

    def __init__(self, cfg: ModelConfig, params, serve: ServeConfig | None = None, *,
                 device=None):
        self.cfg = cfg
        self.serve = serve or ServeConfig()
        self.device = resolve_device(device)
        on = tree_leaves(params)[0].device
        if on != self.device:
            raise ValueError(f"params are on {on}, the server runs on {self.device}")
        self.params = quantize_params(params) if self.serve.quantize else params

    def _fresh_cache(self, batch: int, frames=None):
        kw = {}
        if self.cfg.family == "audio":
            kw = dict(params=self.params, batch={"frames": frames})
        return M.init_decode_cache(self.cfg, batch, self.serve.cache_len,
                                   dtype=getattr(torch, self.serve.cache_dtype), device=self.device,
                                   **kw)

    @torch.inference_mode()
    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 generator: torch.Generator | None = None, frames=None) -> list[list[int]]:
        """Returns the generated continuation (without the prompt) per request.
        ``generator`` drives temperature sampling (default: seed 0 on the
        server's device).  The audio family needs ``frames`` (len(prompts),
        F, d_model): each group of prompts is served over its rows."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if self.cfg.family == "audio":
            if frames is None:
                raise ValueError(f"{self.cfg.name}: audio serving needs the encoder's frames")
            frames = torch.as_tensor(frames, device=self.device)
            if frames.ndim != 3 or frames.shape[0] != len(prompts):
                raise ValueError(f"{self.cfg.name}: frames {tuple(frames.shape)} do not match "
                                 f"{len(prompts)} prompts: one (F, d_model) row a prompt")
        out: list[list[int]] = []
        B = self.serve.max_batch
        for ofs in range(0, len(prompts), B):
            rows = None if frames is None else frames[ofs:ofs + B]
            out.extend(self._generate_group(prompts[ofs:ofs + B], max_new_tokens, generator,
                                            rows))
        return out

    def _generate_group(self, group, max_new, generator, frames=None):
        n = len(group)
        plen = max(len(p) for p in group)
        if plen + max_new > self.serve.cache_len:
            raise ValueError(f"cache too short: prompt {plen} + {max_new} new tokens > "
                             f"cache_len {self.serve.cache_len}")
        # left-pad to a common length
        toks = np.full((n, plen), self.serve.pad_token, np.int64)
        for i, p in enumerate(group):
            toks[i, plen - len(p):] = p
        toks = torch.from_numpy(toks).to(self.device)

        cache = self._fresh_cache(n, frames)
        logits = None
        for t in range(plen):  # prefill (teacher-forced decode)
            logits, cache = M.decode_step(self.params, self.cfg, toks[:, t], cache, t)

        gen = []
        tok = self._sample(logits, generator)
        for t in range(plen, plen + max_new - 1):
            gen.append(tok)
            logits, cache = M.decode_step(self.params, self.cfg, tok, cache, t)
            tok = self._sample(logits, generator)
        gen.append(tok)
        return torch.stack(gen, dim=1).cpu().tolist()

    def _sample(self, logits, generator):
        if self.serve.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.serve.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
