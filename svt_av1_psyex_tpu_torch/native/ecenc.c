/* AV1 multi-symbol range encoder — C backend of bitstream/ec.py.
 *
 * The port's own copy of the shared host tier's coder (native/ecenc.c at
 * the repository root), which it adds work counts to: EcEnc counts the
 * symbols it codes and the calls into its entry points, read by
 * svt_ec_counts. Apart from those counts it codes as the root file does.
 *
 * This is a direct port of this project's own Python EntropyEncoder
 * (bitstream/ec.py), which is a clean-room inverse of
 * the AV1 spec's symbol decoder (spec 8.2). Semantics are pinned by the
 * cross-backend equality tests (tests/test_native_ec.py) and by dav1d
 * conformance of the produced streams.
 *
 * Also hosts the per-txb coefficient emission loop (the hot path of
 * bitstream/coeff_writer.py write_txb: base/base-range symbols, signs,
 * golomb escapes) so Python only prepares vectorized contexts.
 */

#include <string.h>

#include "ecenc.h"

EcEnc *svt_ec_create(void) {
    EcEnc *e = (EcEnc *)calloc(1, sizeof(EcEnc));
    e->cap = 1 << 16;
    e->buf = (uint8_t *)malloc(e->cap);
    e->rng = PROB_TOP;
    e->wbits = 15;
    return e;
}

void svt_ec_free(EcEnc *e) {
    if (e) {
        free(e->buf);
        free(e);
    }
}

void svt_ec_symbol(EcEnc *e, int32_t *cdf, int32_t *cnt, int n, int sym,
                   int adapt) {
    e->n_calls++;
    ec_symbol(e, cdf, cnt, n, sym, adapt);
}

void svt_ec_literal(EcEnc *e, uint32_t value, int n) {
    e->n_calls++;
    ec_literal(e, value, n);
}

void svt_ec_counts(const EcEnc *e, int64_t *out) {
    out[0] = e->n_symbols;
    out[1] = e->n_calls;
}

int64_t svt_ec_done(EcEnc *e, uint8_t *out, int64_t cap) {
    /* non-destructive: computes the terminated stream into out.
       od_ec-compatible termination (see bitstream/ec.py done()): round
       low up to a multiple of 2^14 with bit 14 forced on, then emit the
       top wbits-14 bits (= od_ec's cnt+10; wbits = cnt+24). */
    uint64_t low = e->low;
    int wbits = e->wbits;
    uint64_t m = 0x3FFF;
    uint64_t ev = ((low + m) & ~m) | (m + 1);
    int carry = 0;
    if (ev >> wbits) {
        ev &= ((uint64_t)1 << wbits) - 1;
        carry = 1;
    }
    int s = wbits - 14;
    int nbytes = (s + 7) / 8;
    if (nbytes < 0) nbytes = 0;
    int64_t total = e->len + nbytes;
    if (total == 0) total = 1;
    if (total > cap) return -total;
    memcpy(out, e->buf, e->len);
    if (carry) {
        int64_t i = e->len - 1;
        while (i >= 0 && out[i] == 0xFF) out[i--] = 0;
        out[i] += 1;
    }
    int w = wbits;
    for (int i = 0; i < nbytes; i++) {
        w -= 8;
        if (w >= 0) {
            out[e->len + i] = (uint8_t)((ev >> w) & 0xFF);
            ev &= w ? (((uint64_t)1 << w) - 1) : 0;
        } else {
            out[e->len + i] = (uint8_t)((ev << -w) & 0xFF);
        }
    }
    if (e->len + nbytes == 0) out[0] = 0;
    return total;
}

/* ---- coefficient txb emission (coeff_writer.py write_txb tail) -------- */

#define TX_CLASS_2D 0
#define TX_CLASS_HORIZ 1
#define TX_CLASS_VERT 2
#define NUM_BASE_LEVELS 2
#define COEFF_BASE_RANGE 12
#define BR_CDF_SIZE 4
#define COEFF_CONTEXT_BITS 6
#define COEFF_CONTEXT_MASK ((1 << COEFF_CONTEXT_BITS) - 1)

static int get_br_ctx(const int32_t *levels, int lev_stride, int32_t pos,
                      int bwl, int tx_class) {
    int row = pos >> bwl;
    int col = pos - (row << bwl);
    const int32_t *l = levels + row * lev_stride + col;
    int mag = l[1] + l[lev_stride];
    if (tx_class == TX_CLASS_2D) {
        mag += l[lev_stride + 1];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (row < 2 && col < 2) return mag + 7;
    } else if (tx_class == TX_CLASS_HORIZ) {
        mag += l[2];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (col == 0) return mag + 7;
    } else {
        mag += l[2 * lev_stride];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (row == 0) return mag + 7;
    }
    return mag + 14;
}

/* Emits base/base_eob symbols, base-range symbols, dc sign, sign literals
 * and golomb escapes for one transform block. CDF row group pointers are
 * pre-offset to [ts_ctx][ptype]; row strides are the trailing dims.
 * Returns cul_level (pre dc-sign packing). */
static int64_t ec_coeffs(EcEnc *e, const int32_t *scan, const int32_t *flat,
                         const int32_t *coeff_ctx, int eob,
                         const int32_t *levels, int lev_stride, int bwl,
                         int tx_class,
                         int32_t *base_v, int32_t *base_c,
                         int32_t *beob_v, int32_t *beob_c,
                         int32_t *br_v, int32_t *br_c,
                         int32_t *dcs_v, int32_t *dcs_c, int dc_sign_ctx,
                         int adapt) {
    for (int c = eob - 1; c >= 0; c--) {
        int32_t pos = scan[c];
        int32_t v = flat[pos];
        int32_t level = v < 0 ? -v : v;
        int ctx = coeff_ctx[c];
        if (c == eob - 1) {
            int s = (level < 3 ? level : 3) - 1;
            ec_symbol(e, beob_v + ctx * 3, beob_c + ctx, 3, s, adapt);
        } else {
            int s = level < 3 ? level : 3;
            ec_symbol(e, base_v + ctx * 4, base_c + ctx, 4, s, adapt);
        }
        if (level > NUM_BASE_LEVELS) {
            int base_range = level - 1 - NUM_BASE_LEVELS;
            int br_ctx = get_br_ctx(levels, lev_stride, pos, bwl, tx_class);
            int idx = 0;
            while (idx < COEFF_BASE_RANGE) {
                int k = base_range - idx;
                if (k > BR_CDF_SIZE - 1) k = BR_CDF_SIZE - 1;
                ec_symbol(e, br_v + br_ctx * 4, br_c + br_ctx, 4, k, adapt);
                if (k < BR_CDF_SIZE - 1) break;
                idx += BR_CDF_SIZE - 1;
            }
        }
    }
    int64_t cul_level = 0;
    for (int c = 0; c < eob; c++) {
        int32_t pos = scan[c];
        int32_t v = flat[pos];
        int32_t level = v < 0 ? -v : v;
        cul_level += level;
        if (level) {
            if (c == 0)
                ec_symbol(e, dcs_v + dc_sign_ctx * 2, dcs_c + dc_sign_ctx,
                          2, v < 0 ? 1 : 0, adapt);
            else
                enc_symbol(e, HALF_CDF, 2, v < 0 ? 1 : 0);
            if (level > COEFF_BASE_RANGE + NUM_BASE_LEVELS)
                write_golomb(e, level - COEFF_BASE_RANGE - 1 - NUM_BASE_LEVELS);
        }
    }
    if (cul_level > COEFF_CONTEXT_MASK) cul_level = COEFF_CONTEXT_MASK;
    return cul_level;
}

int64_t svt_ec_coeffs(EcEnc *e, const int32_t *scan, const int32_t *flat,
                      const int32_t *coeff_ctx, int eob,
                      const int32_t *levels, int lev_stride, int bwl,
                      int tx_class,
                      int32_t *base_v, int32_t *base_c,
                      int32_t *beob_v, int32_t *beob_c,
                      int32_t *br_v, int32_t *br_c,
                      int32_t *dcs_v, int32_t *dcs_c, int dc_sign_ctx,
                      int adapt) {
    e->n_calls++;
    return ec_coeffs(e, scan, flat, coeff_ctx, eob, levels, lev_stride, bwl,
                     tx_class, base_v, base_c, beob_v, beob_c, br_v, br_c,
                     dcs_v, dcs_c, dc_sign_ctx, adapt);
}

/* ---- transform stage-network executor (ops/txfm.py _Net.run) ----------
 * Butterfly stage networks compiled to flat index/weight arrays; this
 * executes all stages of one 1-D transform pass over a (batch, n) block.
 * Matches the Python executor exactly (int64 lanes, btf rounding,
 * optional clamping). */

void svt_net_run(int64_t *x, int64_t *tmp, int batch, int n,
                 const int32_t *src0, const int64_t *w0,
                 const int32_t *src1, const int64_t *w1,
                 const uint8_t *is_btf, const uint8_t *do_clamp,
                 int nstages, int cos_bit, int clamp_bit) {
    const int64_t rnd = (int64_t)1 << (cos_bit - 1);
    const int64_t lo = clamp_bit > 0 ? -((int64_t)1 << (clamp_bit - 1)) : 0;
    const int64_t hi = clamp_bit > 0 ? ((int64_t)1 << (clamp_bit - 1)) - 1 : 0;
    int64_t *cur = x, *nxt = tmp;
    for (int s = 0; s < nstages; s++) {
        const int32_t *s0 = src0 + (size_t)s * n;
        const int32_t *s1 = src1 + (size_t)s * n;
        const int64_t *a0 = w0 + (size_t)s * n;
        const int64_t *a1 = w1 + (size_t)s * n;
        const uint8_t *bt = is_btf + (size_t)s * n;
        const uint8_t *cl = do_clamp + (size_t)s * n;
        for (int b = 0; b < batch; b++) {
            const int64_t *row = cur + (size_t)b * n;
            int64_t *out = nxt + (size_t)b * n;
            for (int i = 0; i < n; i++) {
                int64_t y = row[s0[i]] * a0[i] + row[s1[i]] * a1[i];
                if (bt[i]) y = (y + rnd) >> cos_bit;
                if (clamp_bit > 0 && cl[i]) {
                    if (y < lo) y = lo;
                    else if (y > hi) y = hi;
                }
                out[i] = y;
            }
        }
        int64_t *t = cur; cur = nxt; nxt = t;
    }
    if (cur != x)
        memcpy(x, cur, (size_t)batch * n * sizeof(int64_t));
}

/* ---- conformant txb commit (Encode Pass inner kernel) ------------------
 *
 * One call = residual -> forward DCT 2D -> quantize_b -> inverse DCT 2D ->
 * recon writeback for one transform block whose mode was already decided
 * (by the device MD lattice). Counterpart of the reference encode pass's
 * av1_encode_block chain (coding_loop.c:1697) restricted to DCT_DCT;
 * exact same integer networks as svt_net_run / ops/txfm.py.
 *
 * Descriptor layout (int64 slots; pointers stored as int64):
 *   0 tx_w, 1 tx_h
 *   2..8   fwd col net: src0,w0,src1,w1,btf,clp,nstages
 *   9..15  fwd row net
 *   16..22 inv row net
 *   23..29 inv col net
 *   30..32 fwd round_shift bits b0,b1,b2  (round_shift semantics: <0 left)
 *   33..34 inv round_shift bits b0,b1
 *   35 cb_col_fwd, 36 cb_row_fwd, 37 inv_cos_bit
 *   38 inv row net clamp bit, 39 inv col net clamp bit
 *   40 rect (1 => sqrt2 scale fwd, inv_sqrt2 inv)
 *   41 log_scale
 *   42 scan ptr (int32*, cw*ch entries)
 *   43 bit depth
 *   44 inv pre-row clamp bit, 45 inv pre-col clamp bit
 */

typedef struct {
    const int32_t *s0; const int64_t *w0;
    const int32_t *s1; const int64_t *w1;
    const uint8_t *btf; const uint8_t *clp; int ns;
} NetRef;

static void net_from_desc(const int64_t *d, NetRef *n) {
    n->s0 = (const int32_t *)(intptr_t)d[0];
    n->w0 = (const int64_t *)(intptr_t)d[1];
    n->s1 = (const int32_t *)(intptr_t)d[2];
    n->w1 = (const int64_t *)(intptr_t)d[3];
    n->btf = (const uint8_t *)(intptr_t)d[4];
    n->clp = (const uint8_t *)(intptr_t)d[5];
    n->ns = (int)d[6];
}

static inline int64_t rshift64(int64_t x, int bit) {
    if (bit == 0) return x;
    if (bit < 0) return x << (-bit);
    return (x + ((int64_t)1 << (bit - 1))) >> bit;
}

static void vec_rshift(int64_t *x, int n, int bit) {
    if (bit == 0) return;
    for (int i = 0; i < n; i++) x[i] = rshift64(x[i], bit);
}

static void vec_clamp(int64_t *x, int n, int bit) {
    const int64_t lo = -((int64_t)1 << (bit - 1));
    const int64_t hi = ((int64_t)1 << (bit - 1)) - 1;
    for (int i = 0; i < n; i++) {
        if (x[i] < lo) x[i] = lo;
        else if (x[i] > hi) x[i] = hi;
    }
}

static void transpose64(const int64_t *in, int64_t *out, int rows, int cols) {
    for (int r = 0; r < rows; r++)
        for (int c = 0; c < cols; c++)
            out[(size_t)c * rows + r] = in[(size_t)r * cols + c];
}

#define SQRT2 5793
#define INV_SQRT2 2896

static int64_t CBUF_A[64 * 64], CBUF_B[64 * 64], CBUF_T[64 * 64];

extern int svt_rdoq_enabled(void);
extern int32_t svt_rdoq_commit_txb(int tx_enum, int plane, int is_inter,
                                   int qindex, const int32_t *tcoeff,
                                   int32_t *qcoeff, int32_t *dqcoeff,
                                   int32_t eob, const int32_t *scan, int cw,
                                   int ch, int shift, int32_t dqv_dc,
                                   int32_t dqv_ac);

static int32_t RDOQ_TCO[32 * 32], RDOQ_DQ[32 * 32];

int32_t svt_txb_commit(const int64_t *d,
                       const int32_t *src, int src_stride,
                       int32_t *recon, int rec_stride,
                       const int32_t *pred,
                       int x0, int y0,
                       const int64_t *q10, /* zbin,rnd,quant,qshift,deq x dc,ac
                                              (zbin/rnd already log_scale-rounded) */
                       int32_t *qcoeff, /* (ch*cw) raster out */
                       int tx_enum, int plane, int is_inter, int qindex
                       /* tx_enum < 0 disables the RDOQ trellis */) {
    const int w = (int)d[0], h = (int)d[1];
    const int cw = w > 32 ? 32 : w, ch = h > 32 ? 32 : h;
    const int ls = (int)d[41];
    const int bd = (int)d[43];
    const int32_t pixmax = (1 << bd) - 1;
    NetRef fcol, frow, irow, icol;
    net_from_desc(d + 2, &fcol);
    net_from_desc(d + 9, &frow);
    net_from_desc(d + 16, &irow);
    net_from_desc(d + 23, &icol);

    /* residual in lane-major layout for the column pass (batch = w
       columns, lanes = h rows): x[i*batch + b] = resid[i][b], which is
       plain row-major — the lane-major executor's inner loops then run
       contiguously over the batch and vectorize */
    for (int r = 0; r < h; r++) {
        const int32_t *s = src + (size_t)(y0 + r) * src_stride + x0;
        const int32_t *p = pred + (size_t)r * w;
        int64_t *o = CBUF_A + (size_t)r * w;
        for (int c = 0; c < w; c++)
            o[c] = (int64_t)s[c] - p[c];
    }
    vec_rshift(CBUF_A, w * h, (int)d[30]);
    svt_net_run_T(CBUF_A, CBUF_B, w, h, fcol.s0, fcol.w0, fcol.s1, fcol.w1,
                  fcol.btf, fcol.clp, fcol.ns, (int)d[35], 0);
    vec_rshift(CBUF_A, w * h, (int)d[31]);
    /* row pass: lanes along w, batch = first ch coefficient rows (only
       the top-left 32x32 is coded for the 64-class) */
    for (int i = 0; i < w; i++)
        for (int b = 0; b < ch; b++)
            CBUF_T[(size_t)i * ch + b] = CBUF_A[(size_t)b * w + i];
    svt_net_run_T(CBUF_T, CBUF_B, ch, w, frow.s0, frow.w0, frow.s1, frow.w1,
                  frow.btf, frow.clp, frow.ns, (int)d[36], 0);
    vec_rshift(CBUF_T, w * ch, (int)d[32]);
    if (d[40])
        for (int i = 0; i < w * ch; i++)
            CBUF_T[i] = rshift64(CBUF_T[i] * SQRT2, 12);

    /* quantize top-left (ch, cw); coeff (r,c) lives at CBUF_T[c*ch + r].
       dqcoeff goes back into CBUF_A lane-major (w, ch) for the inverse */
    const int32_t *scan = (const int32_t *)(intptr_t)d[42];
    const int n = cw * ch;
    int32_t eob = 0;
    const int do_rdoq = tx_enum >= 0 && svt_rdoq_enabled();
    memset(CBUF_A, 0, (size_t)w * ch * sizeof(int64_t));
    if (do_rdoq) {
        /* fp quantization ahead of the trellis (quantize_fp_helper_c,
         * reference full_loop.c:282): no zbin/quant_shift, round=deq/2 */
        const int64_t deq_dc = q10[4], deq_ac = q10[9];
        const int64_t qfp_dc = (1 << 16) / deq_dc;
        const int64_t qfp_ac = (1 << 16) / deq_ac;
        const int64_t r_dc = ls ? (((64 * deq_dc) >> 7) + (1 << (ls - 1))) >> ls
                                : (64 * deq_dc) >> 7;
        const int64_t r_ac = ls ? (((64 * deq_ac) >> 7) + (1 << (ls - 1))) >> ls
                                : (64 * deq_ac) >> 7;
        for (int r = 0; r < ch; r++) {
            for (int c = 0; c < cw; c++) {
                const int i = r * cw + c;
                const int isdc = (i == 0);
                const int64_t coeff = CBUF_T[(size_t)c * ch + r];
                const int64_t deq = isdc ? deq_dc : deq_ac;
                int64_t a = coeff < 0 ? -coeff : coeff;
                int32_t q = 0;
                int64_t dq = 0;
                if ((a << (1 + ls)) >= deq) {
                    int64_t t = a + (isdc ? r_dc : r_ac);
                    if (t > 32767) t = 32767;
                    q = (int32_t)((t * (isdc ? qfp_dc : qfp_ac)) >>
                                  (16 - ls));
                    dq = ((int64_t)q * deq) >> ls;
                }
                RDOQ_TCO[i] = (int32_t)coeff;
                qcoeff[i] = coeff < 0 ? -q : q;
                RDOQ_DQ[i] = (int32_t)(coeff < 0 ? -dq : dq);
            }
        }
        for (int k = 0; k < n; k++)
            if (qcoeff[scan[k]]) eob = k + 1;
        if (eob)
            eob = svt_rdoq_commit_txb(tx_enum, plane, is_inter, qindex,
                                      RDOQ_TCO, qcoeff, RDOQ_DQ, eob, scan,
                                      cw, ch, ls, (int32_t)deq_dc,
                                      (int32_t)deq_ac);
        for (int r = 0; r < ch; r++)
            for (int c = 0; c < cw; c++)
                CBUF_A[(size_t)c * ch + r] = RDOQ_DQ[r * cw + c];
    } else {
    for (int r = 0; r < ch; r++) {
        for (int c = 0; c < cw; c++) {
            const int i = r * cw + c;
            const int isdc = (i == 0);
            const int64_t coeff = CBUF_T[(size_t)c * ch + r];
            const int64_t zbin = q10[isdc ? 0 : 5];
            const int64_t rnd = q10[isdc ? 1 : 6];
            const int64_t quant = q10[isdc ? 2 : 7];
            const int64_t qshift = q10[isdc ? 3 : 8];
            const int64_t deq = q10[isdc ? 4 : 9];
            int64_t a = coeff < 0 ? -coeff : coeff;
            int32_t q = 0;
            int64_t dq = 0;
            if (a >= zbin) {
                int64_t t = a + rnd;
                if (t > 32767) t = 32767;
                t <<= 5;
                q = (int32_t)((((t * quant) >> 16) + t) * qshift >>
                              (16 - ls + 5));
                dq = ((int64_t)q * deq) >> ls;
            }
            qcoeff[i] = coeff < 0 ? -q : q;
            CBUF_A[(size_t)c * ch + r] = coeff < 0 ? -dq : dq;
        }
    }
    for (int k = 0; k < n; k++)
        if (qcoeff[scan[k]]) eob = k + 1;
    }

    if (!eob) {
        for (int r = 0; r < h; r++) {
            int32_t *o = recon + (size_t)(y0 + r) * rec_stride + x0;
            const int32_t *p = pred + (size_t)r * w;
            for (int c = 0; c < w; c++) {
                int32_t v = p[c];
                o[c] = v < 0 ? 0 : (v > pixmax ? pixmax : v);
            }
        }
        return 0;
    }

    /* inverse row pass: lanes along w, batch = ch dq rows (rows >= ch
       are zero and the 1-D nets map zero to zero) */
    if (d[40])
        for (int i = 0; i < w * ch; i++)
            CBUF_A[i] = rshift64(CBUF_A[i] * INV_SQRT2, 12);
    vec_clamp(CBUF_A, w * ch, (int)d[44]);
    svt_net_run_T(CBUF_A, CBUF_B, ch, w, irow.s0, irow.w0, irow.s1, irow.w1,
                  irow.btf, irow.clp, irow.ns, (int)d[37], (int)d[38]);
    vec_rshift(CBUF_A, w * ch, (int)d[33]);
    /* inverse col pass: lanes along h, batch = w columns */
    memset(CBUF_T, 0, (size_t)w * h * sizeof(int64_t));
    for (int bcol = 0; bcol < w; bcol++)
        for (int ir = 0; ir < ch; ir++)
            CBUF_T[(size_t)ir * w + bcol] = CBUF_A[(size_t)bcol * ch + ir];
    vec_clamp(CBUF_T, w * ch, (int)d[45]);
    svt_net_run_T(CBUF_T, CBUF_B, w, h, icol.s0, icol.w0, icol.s1, icol.w1,
                  icol.btf, icol.clp, icol.ns, (int)d[37], (int)d[39]);
    vec_rshift(CBUF_T, w * h, (int)d[34]);
    /* result is lane-major (h, w) == the image layout */
    for (int r = 0; r < h; r++) {
        int32_t *o = recon + (size_t)(y0 + r) * rec_stride + x0;
        const int32_t *p = pred + (size_t)r * w;
        const int64_t *q = CBUF_T + (size_t)r * w;
        for (int c = 0; c < w; c++) {
            int64_t v = p[c] + q[c];
            o[c] = v < 0 ? 0 : (v > pixmax ? (int32_t)pixmax : (int32_t)v);
        }
    }
    return eob;
}

/* ---- whole-txb coefficient emission -----------------------------------
 * Builds the levels buffer and the per-scan-position nz-map contexts in C
 * (mirrors coeff_writer._nz_map_contexts), then runs svt_ec_coeffs — one
 * host call per transform block instead of numpy context derivation +
 * multi-array marshalling per block.
 * nz_off: per-position (raster, cw*ch) class-specific ctx offsets,
 * precomputed once per tx size/class on the Python side. */
int64_t svt_ec_txb_emit(EcEnc *e, const int32_t *flat, const int32_t *scan,
                        int eob, int cw, int ch, int tx_class,
                        const int32_t *nz_off,
                        int32_t *base_v, int32_t *base_c,
                        int32_t *beob_v, int32_t *beob_c,
                        int32_t *br_v, int32_t *br_c,
                        int32_t *dcs_v, int32_t *dcs_c, int dc_sign_ctx,
                        int adapt) {
    static int32_t levels[(32 + 4) * (32 + 4)];
    static int32_t ctx[32 * 32];
    const int stride = cw + 4;
    memset(levels, 0, (size_t)(ch + 4) * stride * sizeof(int32_t));
    for (int r = 0; r < ch; r++)
        for (int c = 0; c < cw; c++) {
            int32_t v = flat[r * cw + c];
            if (v < 0) v = -v;
            levels[r * stride + c] = v > 127 ? 127 : v;
        }
    const int n = cw * ch;
    int bwl = 0;
    while ((1 << bwl) < cw) bwl++;
    for (int c = 0; c < eob; c++) {
        int32_t pos = scan[c];
        int row = pos >> bwl;
        int col = pos - (row << bwl);
        const int32_t *l = levels + row * stride + col;
#define C3(x) ((x) < 3 ? (x) : 3)
        int mag;
        if (tx_class == TX_CLASS_2D) {
            mag = C3(l[1]) + C3(l[stride]) + C3(l[stride + 1]) + C3(l[2]) +
                  C3(l[2 * stride]);
        } else if (tx_class == TX_CLASS_HORIZ) {
            mag = C3(l[1]) + C3(l[stride]) + C3(l[2]) + C3(l[3]) + C3(l[4]);
        } else { /* VERT */
            mag = C3(l[1]) + C3(l[stride]) + C3(l[2 * stride]) +
                  C3(l[3 * stride]) + C3(l[4 * stride]);
        }
#undef C3
        mag = (mag + 1) >> 1;
        if (mag > 4) mag = 4;
        int cv = mag + nz_off[pos];
        if (tx_class == 0 && row == 0 && col == 0) cv = 0;
        ctx[c] = cv;
    }
    if (eob > 0) { /* eob-position context override */
        int si = eob - 1;
        ctx[eob - 1] = si == 0 ? 0 : (si <= n / 8 ? 1 : (si <= n / 4 ? 2 : 3));
    }
    return ec_coeffs(e, scan, flat, ctx, eob, levels, stride, bwl,
                     tx_class, base_v, base_c, beob_v, beob_c, br_v,
                     br_c, dcs_v, dcs_c, dc_sign_ctx, adapt);
}

int64_t svt_ec_txb(EcEnc *e, const int32_t *flat, const int32_t *scan,
                   int eob, int cw, int ch, int tx_class,
                   const int32_t *nz_off,
                   int32_t *base_v, int32_t *base_c,
                   int32_t *beob_v, int32_t *beob_c,
                   int32_t *br_v, int32_t *br_c,
                   int32_t *dcs_v, int32_t *dcs_c, int dc_sign_ctx,
                   int adapt) {
    e->n_calls++;
    return svt_ec_txb_emit(e, flat, scan, eob, cw, ch, tx_class, nz_off,
                           base_v, base_c, beob_v, beob_c, br_v, br_c,
                           dcs_v, dcs_c, dc_sign_ctx, adapt);
}

/* Lane-major variant of svt_net_run: x[i*batch + b] for lane i, batch b.
 * The inner loop runs contiguously over the batch for each output lane,
 * so the compiler vectorizes it (the batch-major variant needs per-
 * element indexed loads). Used by the commit kernel below. */
void svt_net_run_T(int64_t *x, int64_t *tmp, int batch, int n,
                   const int32_t *src0, const int64_t *w0,
                   const int32_t *src1, const int64_t *w1,
                   const uint8_t *is_btf, const uint8_t *do_clamp,
                   int nstages, int cos_bit, int clamp_bit) {
    const int64_t rnd = (int64_t)1 << (cos_bit - 1);
    const int64_t lo = clamp_bit > 0 ? -((int64_t)1 << (clamp_bit - 1)) : 0;
    const int64_t hi = clamp_bit > 0 ? ((int64_t)1 << (clamp_bit - 1)) - 1 : 0;
    int64_t *cur = x, *nxt = tmp;
    for (int s = 0; s < nstages; s++) {
        const int32_t *s0 = src0 + (size_t)s * n;
        const int32_t *s1 = src1 + (size_t)s * n;
        const int64_t *a0 = w0 + (size_t)s * n;
        const int64_t *a1 = w1 + (size_t)s * n;
        const uint8_t *bt = is_btf + (size_t)s * n;
        const uint8_t *cl = do_clamp + (size_t)s * n;
        for (int i = 0; i < n; i++) {
            const int64_t *r0 = cur + (size_t)s0[i] * batch;
            const int64_t *r1 = cur + (size_t)s1[i] * batch;
            int64_t *o = nxt + (size_t)i * batch;
            const int64_t wa = a0[i], wb = a1[i];
            if (bt[i]) {
                for (int b = 0; b < batch; b++)
                    o[b] = (r0[b] * wa + r1[b] * wb + rnd) >> cos_bit;
            } else {
                for (int b = 0; b < batch; b++)
                    o[b] = r0[b] * wa + r1[b] * wb;
            }
            if (clamp_bit > 0 && cl[i]) {
                for (int b = 0; b < batch; b++) {
                    if (o[b] < lo) o[b] = lo;
                    else if (o[b] > hi) o[b] = hi;
                }
            }
        }
        int64_t *t = cur; cur = nxt; nxt = t;
    }
    if (cur != x)
        memcpy(x, cur, (size_t)batch * n * sizeof(int64_t));
}

/* ---- intra prediction (commit modes) -----------------------------------
 * DC/V/H/SMOOTH/SMOOTH_V/SMOOTH_H/PAETH (the device MD mode set), exact
 * ops/intra.py arithmetic. above: w+1 values including top-left at [0];
 * left: h values. sm_w/sm_h: spec Sm_Weights slices for w and h. */
void svt_intra_predict(int mode, const int32_t *above, const int32_t *left,
                       int w, int h, int have_above, int have_left,
                       int bit_depth, const int32_t *sm_w,
                       const int32_t *sm_h, int32_t *out) {
    const int32_t *ar = above + 1;
    const int32_t tl = above[0];
    switch (mode) {
    case 0: { /* DC */
        int64_t s = 0;
        int32_t dc;
        if (have_above && have_left) {
            for (int i = 0; i < w; i++) s += ar[i];
            for (int i = 0; i < h; i++) s += left[i];
            dc = (int32_t)((s + ((w + h) >> 1)) / (w + h));
        } else if (have_above) {
            for (int i = 0; i < w; i++) s += ar[i];
            int lw = 0; while ((1 << lw) < w) lw++;
            dc = (int32_t)((s + (w >> 1)) >> lw);
        } else if (have_left) {
            for (int i = 0; i < h; i++) s += left[i];
            int lh = 0; while ((1 << lh) < h) lh++;
            dc = (int32_t)((s + (h >> 1)) >> lh);
        } else {
            dc = 1 << (bit_depth - 1);
        }
        for (int i = 0; i < w * h; i++) out[i] = dc;
        break;
    }
    case 1: /* V */
        for (int r = 0; r < h; r++)
            memcpy(out + (size_t)r * w, ar, w * sizeof(int32_t));
        break;
    case 2: /* H */
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++)
                out[r * w + c] = left[r];
        break;
    case 9: { /* SMOOTH */
        const int64_t below = left[h - 1], right = ar[w - 1];
        for (int r = 0; r < h; r++) {
            const int64_t wh = sm_h[r];
            for (int c = 0; c < w; c++) {
                const int64_t ww = sm_w[c];
                int64_t p = wh * ar[c] + (256 - wh) * below +
                            ww * left[r] + (256 - ww) * right;
                out[r * w + c] = (int32_t)((p + 256) >> 9);
            }
        }
        break;
    }
    case 10: { /* SMOOTH_V */
        const int64_t below = left[h - 1];
        for (int r = 0; r < h; r++) {
            const int64_t wh = sm_h[r];
            for (int c = 0; c < w; c++)
                out[r * w + c] =
                    (int32_t)((wh * ar[c] + (256 - wh) * below + 128) >> 8);
        }
        break;
    }
    case 11: { /* SMOOTH_H */
        const int64_t right = ar[w - 1];
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                const int64_t ww = sm_w[c];
                out[r * w + c] =
                    (int32_t)((ww * left[r] + (256 - ww) * right + 128) >> 8);
            }
        break;
    }
    case 12: /* PAETH */
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int32_t a = ar[c], l = left[r], t = tl;
                int32_t base = a + l - t;
                int32_t pa = base - a; if (pa < 0) pa = -pa;
                int32_t pl = base - l; if (pl < 0) pl = -pl;
                int32_t pt = base - t; if (pt < 0) pt = -pt;
                out[r * w + c] = (pl <= pa && pl <= pt) ? l
                                 : (pa <= pt ? a : t);
            }
        break;
    default:
        for (int i = 0; i < w * h; i++) out[i] = 1 << (bit_depth - 1);
    }
}

static int32_t PRED_BUF[64 * 64];

/* predict + commit in one call: neighbors prepared on the host (fill
 * rules incl. availability), everything else in C */
int32_t svt_txb_commit_pred(const int64_t *d,
                            const int32_t *src, int src_stride,
                            int32_t *recon, int rec_stride,
                            int mode, const int32_t *above,
                            const int32_t *left, int have_above,
                            int have_left, const int32_t *sm_w,
                            const int32_t *sm_h,
                            int x0, int y0, const int64_t *q10,
                            int32_t *qcoeff, int tx_enum, int plane,
                            int is_inter, int qindex) {
    const int w = (int)d[0], h = (int)d[1];
    svt_intra_predict(mode, above, left, w, h, have_above, have_left,
                      (int)d[43], sm_w, sm_h, PRED_BUF);
    return svt_txb_commit(d, src, src_stride, recon, rec_stride, PRED_BUF,
                          x0, y0, q10, qcoeff, tx_enum, plane, is_inter,
                          qindex);
}

/* ---- coefficient-context derivation (coeff_writer._txb_ctx) ----------- */
int32_t svt_txb_skip_ctx(const uint8_t *above, const uint8_t *left,
                         int tw_units, int th_units, int is_luma,
                         int same_size, int ctx_offset) {
    static const int8_t sgn[4] = {0, -1, 1, 0};
    int dc = 0;
    for (int i = 0; i < tw_units; i++) dc += sgn[above[i] >> 6];
    for (int i = 0; i < th_units; i++) dc += sgn[left[i] >> 6];
    int dc_sign_ctx = dc > 0 ? 2 : (dc < 0 ? 1 : 0);
    int skip_ctx;
    if (is_luma) {
        if (same_size) {
            skip_ctx = 0;
        } else {
            static const int8_t skip_tbl[5][5] = {
                {1, 2, 2, 2, 3}, {1, 4, 4, 4, 5}, {1, 4, 4, 4, 5},
                {1, 4, 4, 4, 5}, {1, 4, 4, 4, 6}};
            int top = 0, lft = 0;
            for (int i = 0; i < tw_units; i++) top |= above[i];
            for (int i = 0; i < th_units; i++) lft |= left[i];
            top &= COEFF_CONTEXT_MASK;
            lft &= COEFF_CONTEXT_MASK;
            int mx = top | lft; if (mx > 4) mx = 4;
            int mn = top < lft ? top : lft; if (mn > 4) mn = 4;
            skip_ctx = skip_tbl[mn][mx];
        }
    } else {
        int a = 0, l = 0;
        for (int i = 0; i < tw_units; i++) a |= above[i];
        for (int i = 0; i < th_units; i++) l |= left[i];
        skip_ctx = (a != 0) + (l != 0) + ctx_offset;
    }
    return skip_ctx | (dc_sign_ctx << 8);
}
