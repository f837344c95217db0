/* The range coder's state and its symbol primitives, shared by the port's
 * coder (ecenc.c: the entry points from Python) and its superblock
 * writer (tilewriter.c). Semantics as in ecenc.c's header comment. */

#ifndef SVT_TORCH_ECENC_H
#define SVT_TORCH_ECENC_H

#include <stdint.h>
#include <stdlib.h>

#define PROB_TOP (1 << 15)
#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4

typedef struct {
    uint8_t *buf;
    int64_t len, cap;
    uint64_t low; /* window value; low + rng <= 2^wbits */
    uint32_t rng; /* in [2^15, 2^16) */
    int wbits;
    /* work counts, read by svt_ec_counts: symbols coded (a literal's or
       golomb code's bits one each) and calls of the entry points from
       Python (a whole superblock walk one) */
    int64_t n_symbols, n_calls;
} EcEnc;

static inline int bitlen(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

static inline void ec_push(EcEnc *e, uint8_t b) {
    if (e->len == e->cap) {
        e->cap <<= 1;
        e->buf = (uint8_t *)realloc(e->buf, e->cap);
    }
    e->buf[e->len++] = b;
}

static inline void propagate_carry(EcEnc *e) {
    int64_t i = e->len - 1;
    while (i >= 0 && e->buf[i] == 0xFF) e->buf[i--] = 0;
    /* encoder invariant: carry never runs off the stream start */
    e->buf[i] += 1;
}

static inline void add_low(EcEnc *e, uint32_t delta) {
    e->low += delta;
    if (e->low >> e->wbits) {
        e->low &= ((uint64_t)1 << e->wbits) - 1;
        propagate_carry(e);
    }
}

static inline void normalize(EcEnc *e) {
    int d = 15 - (bitlen(e->rng) - 1);
    if (d > 0) {
        e->rng <<= d;
        e->low <<= d;
        e->wbits += d;
    }
    while (e->wbits >= 24) {
        int shift = e->wbits - 8;
        ec_push(e, (uint8_t)(e->low >> shift));
        e->low &= ((uint64_t)1 << shift) - 1;
        e->wbits -= 8;
    }
}

static inline uint32_t interval(uint32_t rng, int32_t cdf_k, int nmk1) {
    uint32_t f = PROB_TOP - (uint32_t)cdf_k;
    return (((rng >> 8) * (f >> EC_PROB_SHIFT)) >> 1) + EC_MIN_PROB * (uint32_t)nmk1;
}

static inline void enc_symbol(EcEnc *e, const int32_t *cdf, int n, int sym) {
    uint32_t r = e->rng;
    e->n_symbols++;
    uint32_t c_prev = sym == 0 ? r : interval(r, cdf[sym - 1], n - sym);
    uint32_t c_cur = interval(r, cdf[sym], n - sym - 1);
    add_low(e, r - c_prev);
    e->rng = c_prev - c_cur;
    normalize(e);
}

static inline void cdf_adapt(int32_t *cdf, int n, int sym, int32_t *cnt) {
    int c = *cnt;
    int l2 = bitlen((uint32_t)n) - 1;
    int rate = 3 + (c > 15) + (c > 31) + (l2 < 2 ? l2 : 2);
    for (int i = 0; i < n - 1; i++) {
        int32_t v = cdf[i];
        cdf[i] = i < sym ? v - (v >> rate) : v + ((PROB_TOP - v) >> rate);
    }
    *cnt = c + (c < 32);
}

static inline void ec_symbol(EcEnc *e, int32_t *cdf, int32_t *cnt, int n,
                             int sym, int adapt) {
    enc_symbol(e, cdf, n, sym);
    if (adapt) cdf_adapt(cdf, n, sym, cnt);
}

static const int32_t HALF_CDF[2] = {PROB_TOP >> 1, PROB_TOP};

static inline void ec_literal(EcEnc *e, uint32_t value, int n) {
    for (int i = n - 1; i >= 0; i--)
        enc_symbol(e, HALF_CDF, 2, (value >> i) & 1);
}

static inline void write_golomb(EcEnc *e, int32_t level) {
    uint32_t x = (uint32_t)level + 1;
    int length = bitlen(x);
    for (int i = 0; i < length - 1; i++) enc_symbol(e, HALF_CDF, 2, 0);
    for (int i = length - 1; i >= 0; i--)
        enc_symbol(e, HALF_CDF, 2, (x >> i) & 1);
}

/* One transform block's coefficients after its eob (ecenc.c): levels and
 * nz-map contexts built in C, then base/range symbols, signs and golomb
 * escapes; returns cul_level before the dc-sign packing. No call count. */
int64_t svt_ec_txb_emit(EcEnc *e, const int32_t *flat, const int32_t *scan,
                        int eob, int cw, int ch, int tx_class,
                        const int32_t *nz_off,
                        int32_t *base_v, int32_t *base_c,
                        int32_t *beob_v, int32_t *beob_c,
                        int32_t *br_v, int32_t *br_c,
                        int32_t *dcs_v, int32_t *dcs_c, int dc_sign_ctx,
                        int adapt);

#endif
