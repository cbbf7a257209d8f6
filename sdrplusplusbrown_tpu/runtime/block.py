"""Block protocol — the vectorized replacement for the reference's
thread-per-block runtime (reference: core/src/dsp/{stream,block,processor}.h).

The reference gives every DSP stage its own OS thread and synchronises with
blocking double-buffer rendezvous (reference: core/src/dsp/stream.h:88-153,
block.h:69-99).  Here a stage is a *pure function over a fixed-size block of
samples with explicit carried state*:

    y, new_state = block.apply(params, state, x)

  * ``x``/``y`` are jnp arrays shaped ``[..., T]`` — leading axes are batched
    VFO channels (the reference runs N VFOs as N independent thread chains;
    we batch them into one tensor, reference: core/src/routing/splitter.h).
  * ``state`` is a pytree (filter tails, NCO phase, AGC envelope...).  This is
    the functional form of the history/carry the reference keeps in mutable
    members (e.g. FIR keeps taps-1 samples, reference fir.h:84-86).
  * ``params`` is a pytree of *runtime-dynamic* knobs (frequency offsets,
    squelch levels) so retuning does not recompile.  Structural settings
    (sample rates, tap counts) are Python-level constructor arguments; changing
    them builds a new block — mirroring the reference's
    tempStop/reconfigure/tempStart protocol without threads.

Static-shape discipline: each block declares ``ratio`` (output/input length,
a Fraction) and ``in_multiple`` (the input length granularity it needs, e.g.
the polyphase decimation factor).  ``Chain`` combines these so a whole
pipeline gets one exact input granularity and every intermediate length is
static — the jit-friendly answer to the reference's variable ``outCount``
(reference: multirate/polyphase_resampler.h:69-99).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


class Block:
    """Base class for stateful stream-processing blocks."""

    #: output_length / input_length (exact rational).
    ratio: Fraction = Fraction(1, 1)
    #: input block length must be a multiple of this.
    in_multiple: int = 1

    def init_state(self, batch_shape: Tuple[int, ...] = ()) -> Any:
        return None

    def init_params(self) -> Any:
        """Default runtime params pytree (empty for most blocks)."""
        return None

    def apply(self, params: Any, state: Any, x: jnp.ndarray):
        raise NotImplementedError

    # Convenience for single-shot use in tests.
    def __call__(self, x, state=None, params=None, batch_shape=None):
        if state is None:
            bs = batch_shape if batch_shape is not None else x.shape[:-1]
            state = self.init_state(bs)
        if params is None:
            params = self.init_params()
        return self.apply(params, state, x)

    def out_len(self, in_len: int) -> int:
        r = Fraction(in_len) * self.ratio
        assert r.denominator == 1, (
            f"{type(self).__name__}: input length {in_len} not a multiple of "
            f"{self.in_multiple} (ratio {self.ratio})")
        return int(r)


def _lcm_fraction(a: Fraction, b: Fraction) -> Fraction:
    """Least common multiple of two positive rationals."""
    return Fraction(math.lcm(a.numerator, b.numerator),
                    math.gcd(a.denominator, b.denominator))


class Chain(Block):
    """Ordered composition of blocks with per-block enable flags.

    Functional analog of the reference's ``dsp::chain<T>``
    (reference: core/src/dsp/chain.h:7-195).  Enable flags are *static*:
    toggling one produces a different compiled program, which mirrors the
    reference's live stream re-splicing under tempStop/tempStart
    (chain.h:62-118) — but state for disabled blocks is preserved so toggles
    are glitch-free.
    """

    def __init__(self, blocks: Sequence[Tuple[str, Block]],
                 enabled: Optional[dict] = None):
        self.named_blocks = list(blocks)
        self.enabled = dict(enabled or {})
        for name, _ in self.named_blocks:
            self.enabled.setdefault(name, True)
        self._recompute_static()

    def _recompute_static(self):
        ratio = Fraction(1, 1)
        need = Fraction(1, 1)
        for name, blk in self.named_blocks:
            if not self.enabled[name]:
                continue
            # input to this block has length L*ratio; it must be a multiple
            # of blk.in_multiple  =>  L must be a multiple of
            # in_multiple / ratio (as a rational, rounded up to integer lcm).
            need = _lcm_fraction(need, Fraction(blk.in_multiple) / ratio)
            ratio *= blk.ratio
        self.ratio = ratio
        # L must be an integer multiple of the rational `need` = p/q (already
        # in lowest terms), and an integer itself; the valid L are exactly the
        # multiples of p (L = k*p/q integer ⇔ q | k ⇔ L multiple of p).
        self.in_multiple = need.numerator

    def set_enabled(self, name: str, value: bool):
        assert name in self.enabled, name
        self.enabled[name] = value
        self._recompute_static()

    def init_state(self, batch_shape=()):
        return {name: blk.init_state(batch_shape)
                for name, blk in self.named_blocks}

    def init_params(self):
        return {name: blk.init_params() for name, blk in self.named_blocks}

    def apply(self, params, state, x):
        params = params or {}
        new_state = dict(state)
        for name, blk in self.named_blocks:
            if not self.enabled[name]:
                continue
            x, new_state[name] = blk.apply(params.get(name), state[name], x)
        return x, new_state


class Identity(Block):
    def apply(self, params, state, x):
        return x, state


def block_granularity(*blocks: Block) -> int:
    """Input granularity for a sequence of blocks applied back to back."""
    return Chain([(str(i), b) for i, b in enumerate(blocks)]).in_multiple


def pick_block_len(chain: Block, target: int) -> int:
    """Smallest input block length >= target satisfying the chain granularity."""
    g = chain.in_multiple
    return ((max(target, 1) + g - 1) // g) * g
