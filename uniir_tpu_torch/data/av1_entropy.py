"""The AV1 symbol decoder (specification section 8.2): a 15-bit range decoder over one tile's bytes, with
each CDF adapted after its symbol unless the frame disables CDF updates, and the per-tile copy of the
default CDFs (av1_tables), the coefficient CDFs chosen by the frame's base_q_idx."""

from __future__ import annotations

from uniir_tpu_torch.data import av1_tables as T

# the non-coefficient CDFs an intra frame reads, and the coefficient CDFs (first axis: quantiser context)
_MODE_CDFS = ("KF_Y_MODE_CDF", "ANGLE_DELTA_CDF", "UV_MODE_CFL_NOT_ALLOWED_CDF", "UV_MODE_CFL_ALLOWED_CDF",
              "PARTITION_W8_CDF", "PARTITION_W16_CDF", "PARTITION_W32_CDF", "PARTITION_W64_CDF",
              "PARTITION_W128_CDF", "INTRA_TX_SET1_CDF", "INTRA_TX_SET2_CDF", "CFL_ALPHA_CDF", "CFL_SIGN_CDF",
              "TX_8X8_CDF", "TX_16X16_CDF", "TX_32X32_CDF", "TX_64X64_CDF", "FILTER_INTRA_CDF",
              "FILTER_INTRA_MODE_CDF", "SKIP_CDF", "SEGMENT_ID_CDF", "RESTORATION_TYPE_CDF", "USE_WIENER_CDF",
              "USE_SGRPROJ_CDF")
_COEF_CDFS = ("TXB_SKIP_CDF", "EOB_EXTRA_CDF", "DC_SIGN_CDF", "EOB_PT_16_CDF", "EOB_PT_32_CDF", "EOB_PT_64_CDF",
              "EOB_PT_128_CDF", "EOB_PT_256_CDF", "EOB_PT_512_CDF", "EOB_PT_1024_CDF", "COEFF_BASE_EOB_CDF",
              "COEFF_BASE_CDF", "COEFF_BR_CDF")


def q_context(base_q_idx: int) -> int:
    return 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 else 2 if base_q_idx <= 120 else 3


def tile_cdfs(base_q_idx: int) -> dict:
    """Fresh, mutable (nested list) copies of every CDF a tile of an intra frame reads."""
    cdfs = {name: getattr(T, name).tolist() for name in _MODE_CDFS}
    q = q_context(base_q_idx)
    cdfs.update({name: getattr(T, name)[q].tolist() for name in _COEF_CDFS})
    delta = T.DELTA_LF_CDF.tolist()
    cdfs["DELTA_Q_CDF"] = list(delta)
    cdfs["DELTA_LF_CDF"] = list(delta)
    cdfs["DELTA_LF_MULTI_CDF"] = [list(delta) for _ in range(4)]
    return cdfs


class SymbolDecoder:
    """init_symbol / read_symbol / read_literal over `data` (exit_symbol's padding is not checked: dav1d
    does not either; `max_bits` below -14 is its overread, which the tile decoder checks)."""

    def __init__(self, data: bytes, disable_update: bool, name: str):
        self.data = bytes(data) + b"\0\0\0\0"
        self.name = name
        self.update = not disable_update
        self.bitpos = 0
        size = len(data)
        n = min(size * 8, 15)
        buf = self._bits(n)
        self.value = ((1 << 15) - 1) ^ (buf << (15 - n))
        self.range = 1 << 15
        self.max_bits = 8 * size - 15

    def _bits(self, n: int) -> int:
        p = self.bitpos
        b = p >> 3
        chunk = self.data[b] << 16 | self.data[b + 1] << 8 | self.data[b + 2]
        self.bitpos = p + n
        return (chunk >> (24 - (p & 7) - n)) & ((1 << n) - 1)

    def symbol(self, cdf: list) -> int:
        n = len(cdf) - 1
        rng = self.range
        value = self.value
        r8 = rng >> 8
        cur = rng
        sym = -1
        extra = 4 * (n - 1)
        while True:
            sym += 1
            prev = cur
            cur = ((r8 * ((32768 - cdf[sym]) >> 6)) >> 1) + extra
            extra -= 4
            if value >= cur:
                break
        rng = prev - cur
        value -= cur
        bits = 16 - rng.bit_length()
        if bits:  # renormalise, reading up to `bits` new bits (zeros past the tile's end)
            left = self.max_bits
            num = bits if bits <= left else (left if left > 0 else 0)
            value = ((value + 1) << bits) - 1
            if num:
                p = self.bitpos
                d = self.data
                k = p >> 3
                new = ((d[k] << 16 | d[k + 1] << 8 | d[k + 2]) >> (24 - (p & 7) - num)) & ((1 << num) - 1)
                self.bitpos = p + num
                value ^= new << (bits - num)
            rng <<= bits
            self.max_bits = left - bits
        self.range, self.value = rng, value
        if self.update:
            count = cdf[n]
            rate = (4 if n < 4 else 5) + (count > 15) + (count > 31)
            for i in range(sym):
                cdf[i] -= cdf[i] >> rate
            for i in range(sym, n - 1):
                cdf[i] += (32768 - cdf[i]) >> rate
            cdf[n] = count + (count < 32)
        return sym

    def literal(self, n: int) -> int:
        """n bools of probability one half, most significant first."""
        x = 0
        rng, value = self.range, self.value
        for _ in range(n):
            cur = ((rng >> 8) << 7) + 4  # the CDF [16384, 32768]: (rng >> 8) * (16384 >> 6) >> 1, + 4
            if value >= cur:
                rng, value, x = rng - cur, value - cur, 2 * x
            else:
                rng, x = cur, 2 * x + 1
            bits = 16 - rng.bit_length()
            if bits:
                left = self.max_bits
                num = bits if bits <= left else (left if left > 0 else 0)
                value = ((value + 1) << bits) - 1
                if num:
                    p = self.bitpos
                    d = self.data
                    k = p >> 3
                    new = ((d[k] << 16 | d[k + 1] << 8 | d[k + 2]) >> (24 - (p & 7) - num)) & ((1 << num) - 1)
                    self.bitpos = p + num
                    value ^= new << (bits - num)
                rng <<= bits
                self.max_bits = left - bits
        self.range, self.value = rng, value
        return x
