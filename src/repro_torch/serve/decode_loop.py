"""Serving driver: greedy decode over the static-batch KV cache, and
teacher-forced scoring through prefill (port of
``repro.serve.decode_loop``).

``generate`` fills the cache by feeding the prompt through decode steps
one token at a time, as the reference does, then decodes greedily;
``score`` sums the teacher-forced log-probs of a batch from one prefill.
The session runs where its model's parameters live.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import transformer


@dataclasses.dataclass
class ServeSession:
    cfg: LMConfig
    params: transformer.Transformer
    max_seq: int
    batch: int

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, steps: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """prompt [B, S0] -> (generated [B, steps] int32, last logits)."""
        b, s0 = prompt.shape
        if b != self.batch or s0 + steps > self.max_seq:
            raise ValueError(f"prompt {tuple(prompt.shape)} + {steps} steps "
                             f"does not fit batch {self.batch}, max_seq "
                             f"{self.max_seq}")
        prompt = prompt.to(self.params.device)
        cache = transformer.init_cache(self.cfg, b, self.max_seq,
                                       self.params.device)
        logits = None
        for i in range(s0):
            logits, cache = transformer.decode_step(
                self.params, cache, prompt[:, i:i + 1], i)
        out = []
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        for i in range(steps):
            out.append(tok)
            logits, cache = transformer.decode_step(self.params, cache, tok,
                                                    s0 + i)
            tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        return torch.cat(out, dim=1), logits

    @torch.no_grad()
    def score(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced log-probs via prefill (batch scoring path):
        tokens [B, S] -> [B] f32."""
        tokens = tokens.to(self.params.device)
        logits = transformer.prefill_logits(self.params, tokens)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        gold = logp[:, :-1].gather(-1, tokens[:, 1:, None].long())[..., 0]
        return gold.sum(dim=-1)
