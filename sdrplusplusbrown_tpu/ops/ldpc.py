"""Batched LDPC encode / belief-propagation decode.

The reference decodes FT8's LDPC(174,91) with a scalar C++ belief
propagator over adjacency lists, one candidate at a time
(decoder_modules/ft8_decoder/src/ft8_etc/bpdecode_ft8_174_91.h — table
header; the BP loop lives in the vendored MSHV decoder).  Here the
decoder is a DENSE masked formulation batched over candidates: the
message tensor is [B, M, N] (B candidates, M checks, N variables) and
each normalized-min-sum iteration is a handful of masked reductions —
all dense-array friendly, no gather/scatter, one `lax.scan` over a fixed
iteration count.  For FT8's 83×174 matrix the mask is 14 KB; hundreds
of sync candidates decode in one jitted call.

Works for any systematic code given the generator rows; the FT8 matrix
ships in models/ft8_tables.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class SystematicLDPC:
    """Systematic binary LDPC code: codeword = [message(K) | parity(M)].

    ``generator_hex``: M rows of hex digits, each encoding K bits
    MSB-first (trailing pad bits in the last nibble ignored) — used for
    encoding (parity = P @ msg).

    ``check_adjacency``: the SPARSE parity-check matrix as M lists of
    1-based variable indices (row weight ~7 for FT8).  BP must run on
    this, not on the dense [P | I_M] derived from the generator: both
    span the same dual space, but min-sum over ~46-weight rows does not
    converge.  When omitted, [P | I_M] is used (fine for syndrome
    checking and high-SNR sanity, not for real decoding).
    """

    def __init__(self, generator_hex, K: int, check_adjacency=None):
        M = len(generator_hex)
        P = np.zeros((M, K), np.uint8)
        for i, row in enumerate(generator_hex):
            bits = np.array(
                [(int(c, 16) >> (3 - j)) & 1
                 for c in row for j in range(4)], np.uint8)
            P[i] = bits[:K]
        self.K, self.M, self.N = K, M, K + M
        self.P = P
        if check_adjacency is not None:
            H = np.zeros((M, self.N), np.uint8)
            for i, vs in enumerate(check_adjacency):
                for v in vs:
                    H[i, v - 1] = 1
        else:
            H = np.concatenate([P, np.eye(M, dtype=np.uint8)], axis=1)
        self.H = H
        self._Hm = jnp.asarray(self.H.astype(np.float32))
        self._Hb = jnp.asarray(self.H.astype(bool))

    # ---------------- encode ----------------

    def encode(self, msg_bits: np.ndarray) -> np.ndarray:
        """[..., K] 0/1 → [..., N] codeword (numpy, host-side)."""
        m = np.asarray(msg_bits, np.uint8)
        parity = (m @ self.P.T) % 2 if m.ndim == 1 else \
            np.einsum("...k,mk->...m", m, self.P) % 2
        return np.concatenate([m, parity.astype(np.uint8)], axis=-1)

    # ---------------- decode ----------------

    def decode(self, llrs, iters: int = 30, alpha: float = 0.8):
        """Normalized min-sum BP.

        llrs: [B, N] log(P(bit=0)/P(bit=1)).  Returns (bits [B, N] uint8,
        ok [B] bool) — ok means all parity checks satisfied.  Fixed
        iteration count (static shape; no early exit under jit).
        """
        llrs = jnp.asarray(llrs, jnp.float32)
        B = llrs.shape[0]
        Hb = self._Hb                        # [M, N]
        mask = self._Hm                      # [M, N] {0,1}
        BIG = jnp.float32(1e9)

        def step(msgs, _):
            # msgs: [B, M, N] check→variable messages
            # variable→check: total posterior minus own incoming message
            post = llrs[:, None, :] + jnp.sum(msgs, axis=1, keepdims=True)
            v2c = (post - msgs) * mask       # [B, M, N]
            # check→variable (min-sum with self-exclusion):
            a = jnp.abs(v2c) + (1.0 - mask) * BIG
            m1 = jnp.min(a, axis=2, keepdims=True)            # [B, M, 1]
            i1 = jnp.argmin(a, axis=2)                        # [B, M]
            a2 = a + jax.nn.one_hot(i1, a.shape[2]) * BIG
            m2 = jnp.min(a2, axis=2, keepdims=True)
            is_min = jax.nn.one_hot(i1, a.shape[2], dtype=a.dtype)
            mag = m1 * (1.0 - is_min) + m2 * is_min           # exclude self
            sgn = jnp.where(v2c < 0, -1.0, 1.0) * mask + (1.0 - mask)
            total_sign = jnp.prod(sgn, axis=2, keepdims=True)
            sgn_excl = total_sign * sgn      # sign ∈ {±1} ⇒ division = mul
            new = alpha * sgn_excl * mag * mask
            return new, ()

        msgs0 = jnp.zeros((B, self.M, self.N), jnp.float32)
        msgs, _ = jax.lax.scan(step, msgs0, None, length=iters)
        post = llrs + jnp.sum(msgs, axis=1)
        bits = (post < 0).astype(jnp.uint8)                   # [B, N]
        syndrome = jnp.einsum("bn,mn->bm", bits.astype(jnp.int32),
                              Hb.astype(jnp.int32)) % 2
        ok = jnp.all(syndrome == 0, axis=1)
        return bits, ok
