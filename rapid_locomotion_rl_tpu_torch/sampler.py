"""One source of random draws for the env and the rollout.

The JAX package splits a PRNG key into streams (push, DOF props, command
resample, reset, noise, terrain, action noise, minibatch permutation). PyTorch cannot reproduce
those bits, so every draw of the port goes through a :class:`Sampler` and
names the stream it belongs to. The default sampler takes every draw from
one ``torch.Generator`` on the env's device; a test can subclass it to fix,
replay or switch off the draws of any stream by name.
"""

from __future__ import annotations

from typing import Sequence

import torch


class Sampler:
    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, name: str, shape: Sequence[int], lo, hi
                ) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator,
                       device=self.device)
        return u * (hi - lo) + lo

    def normal(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def integers(self, name: str, shape: Sequence[int], lo: int, hi: int
                 ) -> torch.Tensor:
        """Integers drawn uniformly from [lo, hi)."""
        return torch.randint(int(lo), int(hi), tuple(shape),
                             generator=self.generator, device=self.device)

    def permutation(self, name: str, n: int) -> torch.Tensor:
        return torch.randperm(int(n), generator=self.generator,
                              device=self.device)

    def categorical(self, name: str, weights: torch.Tensor, n: int
                    ) -> torch.Tensor:
        """n indices drawn with probability proportional to ``weights``."""
        return torch.multinomial(weights, n, replacement=True,
                                 generator=self.generator)
