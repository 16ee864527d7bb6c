/* sz_tpu native host runtime.
 *
 * The device engine (sz_tpu/tpu/engine.py) does the data-parallel heavy
 * lifting on-device; this small C library covers the strictly-serial
 * host-side pieces where Python/numpy would dominate the wall clock:
 *   - ordered float accumulation (C `acc += x` semantics, needed for
 *     bit-exact means; reference e.g. sz_float.c:6658-6669)
 *   - Huffman bitstream pack (reference encode(), Huffman.c:205-308)
 *   - byte-level FSM Huffman decode (reference decode(), Huffman.c:310)
 *   - the coefficient delta-quantization chain (sz_float.c:6787-6814)
 *
 * Exposed via ctypes (no pybind11 in this environment).
 */

#include <stdint.h>
#include <stdlib.h>
#include <stddef.h>
#include <string.h>
#include <math.h>
#ifdef _OPENMP
#include <omp.h>
#endif

/* ------------------------------------------------------------------ */
/* Ordered accumulation                                                */
/* ------------------------------------------------------------------ */

float seq_sum_f32(const float *x, int64_t n) {
    float acc = 0.0f;
    for (int64_t i = 0; i < n; i++) acc += x[i];
    return acc;
}

double seq_sum_f64(const double *x, int64_t n) {
    double acc = 0.0;
    for (int64_t i = 0; i < n; i++) acc += x[i];
    return acc;
}

/* ------------------------------------------------------------------ */
/* Huffman bitstream pack (MSB-first, codes <= 128 bits)               */
/* ------------------------------------------------------------------ */

/* Append `len` (<=64) MSB-aligned bits of `word` to the stream.
 * Invariant: accbits < 8 on entry and exit of the caller's loop body. */
static inline int64_t put_bits(uint64_t word, int len, uint64_t *acc,
                               int *accbits, uint8_t *out, int64_t ob) {
    int room = 64 - *accbits;
    int placed = len < room ? len : room;
    *acc |= word >> *accbits;
    *accbits += placed;
    while (*accbits >= 8) {
        out[ob++] = (uint8_t)(*acc >> 56);
        *acc <<= 8;
        *accbits -= 8;
    }
    int rem = len - placed;
    if (rem > 0) {
        *acc |= (word << placed) >> *accbits;
        *accbits += rem;
        while (*accbits >= 8) {
            out[ob++] = (uint8_t)(*acc >> 56);
            *acc <<= 8;
            *accbits -= 8;
        }
    }
    return ob;
}

/* Returns number of bytes written.  out must hold ceil(total_bits/8). */
int64_t huff_encode(const int32_t *syms, int64_t n,
                    const uint64_t *code_hi, const uint64_t *code_lo,
                    const uint8_t *code_len, uint8_t *out) {
    uint64_t acc = 0;       /* pending bits, MSB-aligned */
    int accbits = 0;
    int64_t ob = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t s = syms[i];
        int len = code_len[s];
        if (len <= 64) {
            ob = put_bits(code_hi[s], len, &acc, &accbits, out, ob);
        } else {
            ob = put_bits(code_hi[s], 64, &acc, &accbits, out, ob);
            ob = put_bits(code_lo[s], len - 64, &acc, &accbits, out, ob);
        }
    }
    if (accbits > 0) out[ob++] = (uint8_t)(acc >> 56);
    return ob;
}

/* total bit count helper */
int64_t huff_total_bits(const int32_t *syms, int64_t n,
                        const uint8_t *code_len) {
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) total += code_len[syms[i]];
    return total;
}

/* ------------------------------------------------------------------ */
/* Byte-level FSM Huffman decode                                       */
/* ------------------------------------------------------------------ */

/* next_state: [n_states][256] int32; emit_cnt: [n_states][256] int8;
 * emit_syms: [n_states][256][8] int32.  Decodes `count` symbols. */
int64_t huff_fsm_decode(const int32_t *next_state, const int8_t *emit_cnt,
                        const int32_t *emit_syms, const uint8_t *data,
                        int64_t nbytes, int32_t *out, int64_t count) {
    int64_t k = 0;
    int32_t s = 0;
    for (int64_t i = 0; i < nbytes; i++) {
        uint8_t b = data[i];
        int64_t base = ((int64_t)s << 8) | b;
        int cnt = emit_cnt[base];
        if (cnt) {
            const int32_t *sy = emit_syms + base * 8;
            for (int j = 0; j < cnt && k < count; j++) out[k++] = sy[j];
            if (k >= count) return k;
        }
        s = next_state[base];
    }
    return k;
}

/* Bit-walk decode over the flat serialized tree (fallback, and used for
 * the coefficient streams where building an FSM is not worth it). */
int64_t huff_tree_decode(const int32_t *L, const int32_t *R,
                         const int32_t *C, const uint8_t *T,
                         const uint8_t *data, int64_t nbytes,
                         int32_t *out, int64_t count) {
    int64_t k = 0;
    int32_t n = 0;
    for (int64_t i = 0; i < nbytes && k < count; i++) {
        uint8_t byte = data[i];
        for (int bit = 7; bit >= 0; bit--) {
            n = (byte >> bit) & 1 ? R[n] : L[n];
            if (T[n]) {
                out[k++] = C[n];
                if (k >= count) break;
                n = 0;
            }
        }
    }
    return k;
}

/* ------------------------------------------------------------------ */
/* Coefficient delta-quantization chain (float / double)               */
/* ------------------------------------------------------------------ */

/* For each reg block (rows of coeffs[nreg][nc]), quantize each coeff
 * against the previous reconstructed value.  Outputs:
 *   ctypes[nc][nreg]   type codes
 *   unpred[nc][nreg]   escape values (compacted per coeff; counts out)
 *   qcoeffs[nreg][nc]  reconstructed coefficients
 * use_mean selects the multiply-by-reciprocal form (sz_float.c:6699). */
void coeff_chain_f32(const float *coeffs, int64_t nreg, int nc,
                     const float *precision, int use_mean,
                     int32_t *ctypes, float *unpred, int64_t *unpred_cnt,
                     float *qcoeffs, int capacity, int radius) {
    float last[8] = {0};
    float recip[8];
    for (int e = 0; e < nc; e++) {
        recip[e] = 1.0f / precision[e];
        unpred_cnt[e] = 0;
    }
    float cap = (float)capacity;
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            float cur = coeffs[n * nc + e];
            float diff = cur - last[e];
            float itv = use_mean ? fabsf(diff) * recip[e] + 1.0f
                                 : fabsf(diff) / precision[e] + 1.0f;
            int32_t t = 0;
            if (itv < cap) {
                if (diff < 0) itv = -itv;
                t = (int32_t)(itv / 2.0f) + radius;
                float rec = last[e] + (float)(2 * (t - radius)) * precision[e];
                if (fabsf(cur - rec) > precision[e]) {
                    t = 0;
                    last[e] = cur;
                    unpred[e * nreg + unpred_cnt[e]++] = cur;
                } else {
                    last[e] = rec;
                }
            } else {
                last[e] = cur;
                unpred[e * nreg + unpred_cnt[e]++] = cur;
            }
            ctypes[e * nreg + n] = t;
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

void coeff_chain_f64(const double *coeffs, int64_t nreg, int nc,
                     const double *precision, int use_mean,
                     int32_t *ctypes, double *unpred, int64_t *unpred_cnt,
                     double *qcoeffs, int capacity, int radius) {
    double last[8] = {0};
    double recip[8];
    for (int e = 0; e < nc; e++) {
        recip[e] = 1.0 / precision[e];
        unpred_cnt[e] = 0;
    }
    double cap = (double)capacity;
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            double cur = coeffs[n * nc + e];
            double diff = cur - last[e];
            double itv = use_mean ? fabs(diff) * recip[e] + 1.0
                                  : fabs(diff) / precision[e] + 1.0;
            int32_t t = 0;
            if (itv < cap) {
                if (diff < 0) itv = -itv;
                t = (int32_t)(itv / 2.0) + radius;
                double rec = last[e] + (double)(2 * (t - radius)) * precision[e];
                if (fabs(cur - rec) > precision[e]) {
                    t = 0;
                    last[e] = cur;
                    unpred[e * nreg + unpred_cnt[e]++] = cur;
                } else {
                    last[e] = rec;
                }
            } else {
                last[e] = cur;
                unpred[e * nreg + unpred_cnt[e]++] = cur;
            }
            ctypes[e * nreg + n] = t;
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

/* Decode side of the chain (szd_float.c:3376-3414). */
void coeff_chain_decode_f32(const int32_t *ctypes, int64_t nreg, int nc,
                            const float *precision, const int32_t *cradius,
                            const float *unpred, const int64_t *stride,
                            float *qcoeffs) {
    float last[8] = {0};
    int64_t ucnt[8] = {0};
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            int32_t t = ctypes[e * nreg + n];
            if (t != 0)
                last[e] = last[e] + (float)(2 * (t - cradius[e])) * precision[e];
            else
                last[e] = unpred[e * stride[0] + ucnt[e]++];
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

void coeff_chain_decode_f64(const int32_t *ctypes, int64_t nreg, int nc,
                            const double *precision, const int32_t *cradius,
                            const double *unpred, const int64_t *stride,
                            double *qcoeffs) {
    double last[8] = {0};
    int64_t ucnt[8] = {0};
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            int32_t t = ctypes[e * nreg + n];
            if (t != 0)
                last[e] = last[e] + (double)(2 * (t - cradius[e])) * precision[e];
            else
                last[e] = unpred[e * stride[0] + ucnt[e]++];
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

/* uint16 symbol variant of huff_encode (type streams are uint16 on the
 * device side; avoids a 2x-size int32 conversion on slow hosts). */
int64_t huff_encode_u16(const uint16_t *syms, int64_t n,
                        const uint64_t *code_hi, const uint64_t *code_lo,
                        const uint8_t *code_len, uint8_t *out) {
    uint64_t acc = 0;
    int accbits = 0;
    int64_t ob = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t s = syms[i];
        int len = code_len[s];
        if (len <= 64) {
            ob = put_bits(code_hi[s], len, &acc, &accbits, out, ob);
        } else {
            ob = put_bits(code_hi[s], 64, &acc, &accbits, out, ob);
            ob = put_bits(code_lo[s], len - 64, &acc, &accbits, out, ob);
        }
    }
    if (accbits > 0) out[ob++] = (uint8_t)(acc >> 56);
    return ob;
}

int64_t huff_total_bits_u16(const uint16_t *syms, int64_t n,
                            const uint8_t *code_len) {
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) total += code_len[syms[i]];
    return total;
}

/* libm-vectorized transcendentals: the PW_REL pre-log transform maps
 * through log2()/exp2() whose numpy SIMD implementations differ from
 * glibc libm in the last ulp — double streams multiply by these values
 * directly (sz_double_pwr.c pre_log), so parity requires the same libm
 * the reference binary links. */
void v_log2_f64(const double *x, double *out, int64_t n) {
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; i++) out[i] = log2(x[i]);
}

void v_exp2_f64(const double *x, double *out, int64_t n) {
    /* elementwise: threading preserves per-element bit-exactness; the
     * prelog decode's exp2 inputs are subnormal-heavy (zeros flushed
     * below minLog) and hit the libm slow path */
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; i++) out[i] = exp2(x[i]);
}

/* ------------------------------------------------------------------ */
/* Batched per-block Huffman encode (random-access / sz_omp formats:   */
/* one shared code table, each block's bitstream padded to a byte      */
/* boundary and concatenated).                                         */
/* ------------------------------------------------------------------ */

/* Per-block byte sizes; returns the total byte count. */
int64_t huff_block_sizes(const int32_t *syms, int64_t nb, int64_t ncell,
                         const uint8_t *code_len, uint32_t *sizes) {
    int64_t total = 0;
    for (int64_t b = 0; b < nb; b++) {
        const int32_t *s = syms + b * ncell;
        int64_t bits = 0;
        for (int64_t i = 0; i < ncell; i++) bits += code_len[s[i]];
        sizes[b] = (uint32_t)((bits + 7) / 8);
        total += sizes[b];
    }
    return total;
}

/* Encode all blocks into `out` (sized by huff_block_sizes). */
void huff_encode_blocks(const int32_t *syms, int64_t nb, int64_t ncell,
                        const uint64_t *code_hi, const uint64_t *code_lo,
                        const uint8_t *code_len, const uint32_t *sizes,
                        uint8_t *out) {
    int64_t *offs = malloc((nb + 1) * sizeof(int64_t));
    offs[0] = 0;
    for (int64_t b = 0; b < nb; b++) offs[b + 1] = offs[b] + sizes[b];
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t b = 0; b < nb; b++)
        huff_encode(syms + b * ncell, ncell, code_hi, code_lo,
                    code_len, out + offs[b]);
    free(offs);
}

/* ------------------------------------------------------------------ */
/* Huffman tree construction: exact replica of the reference algorithm */
/* (1-indexed non-stable min-heap, creation-order node ids, gcc        */
/* right-to-left argument evaluation making the first removal the      */
/* RIGHT child, preorder pad/serialize).                               */
/* ------------------------------------------------------------------ */

typedef struct {
    int64_t *slots;
    int64_t *freqs;
    int64_t qend;
} hheap;

static void hheap_insert(hheap *h, int64_t node_id, int64_t freq) {
    int64_t i = h->qend++;
    while (1) {
        int64_t j = i >> 1;
        if (j == 0 || h->freqs[j] <= freq) break;
        h->slots[i] = h->slots[j];
        h->freqs[i] = h->freqs[j];
        i = j;
    }
    h->slots[i] = node_id;
    h->freqs[i] = freq;
}

static int64_t hheap_remove(hheap *h) {
    int64_t n = h->slots[1];
    if (h->qend < 2) return -1;
    h->qend--;
    int64_t qend = h->qend;
    h->slots[1] = h->slots[qend];
    h->freqs[1] = h->freqs[qend];
    int64_t i = 1;
    while (1) {
        int64_t l = i << 1;
        if (l >= qend) break;
        if (l + 1 < qend && h->freqs[l + 1] < h->freqs[l]) l++;
        if (h->freqs[i] > h->freqs[l]) {
            int64_t ts = h->slots[i]; h->slots[i] = h->slots[l]; h->slots[l] = ts;
            int64_t tf = h->freqs[i]; h->freqs[i] = h->freqs[l]; h->freqs[l] = tf;
            i = l;
        } else break;
    }
    return n;
}

/* Build tree + assign codes + preorder-serialize.  freq: int64[freq_len];
 * code_*: [state_num]; L/R/C/T: [node_count] with node_count=2*nnz-1
 * precomputed by the caller.  Returns node_count, or -1 if nnz < 1
 * (caller falls back). */
int64_t huff_build_tree(const int64_t *freq, int64_t freq_len,
                        int64_t state_num,
                        uint64_t *code_hi, uint64_t *code_lo,
                        uint8_t *code_len,
                        uint32_t *L, uint32_t *R, uint32_t *C, uint8_t *T) {
    int64_t nnz = 0;
    for (int64_t s = 0; s < freq_len; s++) if (freq[s]) nnz++;
    if (nnz < 1) return -1;
    int64_t max_nodes = 2 * nnz + 2;
    int64_t *left  = malloc(max_nodes * sizeof(int64_t));
    int64_t *right = malloc(max_nodes * sizeof(int64_t));
    int64_t *sym   = malloc(max_nodes * sizeof(int64_t));
    uint8_t *leaf  = calloc(max_nodes, 1);
    int64_t *nfreq = malloc(max_nodes * sizeof(int64_t));
    hheap h;
    h.slots = calloc(max_nodes + 2, sizeof(int64_t));
    h.freqs = calloc(max_nodes + 2, sizeof(int64_t));
    h.qend = 1;
    int64_t n_nodes = 0;
    for (int64_t s = 0; s < freq_len; s++) {
        if (!freq[s]) continue;
        left[n_nodes] = -1; right[n_nodes] = -1;
        sym[n_nodes] = s; leaf[n_nodes] = 1; nfreq[n_nodes] = freq[s];
        hheap_insert(&h, n_nodes, freq[s]);
        n_nodes++;
    }
    while (h.qend > 2) {
        int64_t b = hheap_remove(&h);   /* first removed -> RIGHT child */
        int64_t a = hheap_remove(&h);
        left[n_nodes] = a; right[n_nodes] = b;
        leaf[n_nodes] = 0; sym[n_nodes] = 0;
        int64_t f = nfreq[a] + nfreq[b];
        nfreq[n_nodes] = f;
        hheap_insert(&h, n_nodes, f);
        n_nodes++;
    }
    int64_t root = h.slots[1];

    /* code assignment (build_code, Huffman.c:122-157) */
    for (int64_t s = 0; s < state_num; s++) {
        code_hi[s] = 0; code_lo[s] = 0; code_len[s] = 0;
    }
    int64_t cap = n_nodes + 4;
    int64_t *st_n = malloc(cap * sizeof(int64_t));
    int     *st_l = malloc(cap * sizeof(int));
    uint64_t *st_1 = malloc(cap * sizeof(uint64_t));
    uint64_t *st_2 = malloc(cap * sizeof(uint64_t));
    int64_t sp = 0;
    st_n[sp] = root; st_l[sp] = 0; st_1[sp] = 0; st_2[sp] = 0; sp++;
    while (sp > 0) {
        sp--;
        int64_t n = st_n[sp];
        int ln = st_l[sp];
        uint64_t o1 = st_1[sp], o2 = st_2[sp];
        if (leaf[n]) {
            int64_t s = sym[n];
            if (s >= state_num) continue;  /* malformed stream; Python
                                            * oracle raises here */
            if (ln <= 64) {
                code_hi[s] = ln ? (o1 << (64 - ln)) : 0;
                code_lo[s] = o2;
            } else if (ln <= 128) {
                code_hi[s] = o1;
                code_lo[s] = (ln < 128) ? (o2 << (128 - ln)) : o2;
            }
            code_len[s] = (uint8_t)ln;
            continue;
        }
        if ((ln >> 6) == 0) {
            uint64_t n1 = o1 << 1;
            st_n[sp] = right[n]; st_l[sp] = ln + 1; st_1[sp] = n1 | 1; st_2[sp] = 0; sp++;
            st_n[sp] = left[n];  st_l[sp] = ln + 1; st_1[sp] = n1;     st_2[sp] = 0; sp++;
        } else {
            uint64_t n2 = (ln % 64 != 0) ? (o2 << 1) : o2;
            st_n[sp] = right[n]; st_l[sp] = ln + 1; st_1[sp] = o1; st_2[sp] = n2 | 1; sp++;
            st_n[sp] = left[n];  st_l[sp] = ln + 1; st_1[sp] = o1; st_2[sp] = n2; sp++;
        }
    }

    /* preorder serialization (pad_tree_*, node->left before node->right) */
    int64_t node_count = 2 * nnz - 1;
    int64_t *pn = malloc((node_count + 4) * sizeof(int64_t));
    int64_t *pp = malloc((node_count + 4) * sizeof(int64_t));
    int8_t  *pr = malloc(node_count + 4);
    int64_t psp = 0, counter = 0;
    pn[psp] = root; pp[psp] = -1; pr[psp] = 0; psp++;
    while (psp > 0) {
        psp--;
        int64_t n = pn[psp], parent = pp[psp];
        int8_t isr = pr[psp];
        int64_t idx = counter++;
        if (parent >= 0) {
            if (isr) R[parent] = (uint32_t)idx;
            else     L[parent] = (uint32_t)idx;
        }
        C[idx] = (uint32_t)sym[n];
        T[idx] = leaf[n] ? 1 : 0;
        if (!leaf[n]) {
            if (right[n] >= 0) { pn[psp] = right[n]; pp[psp] = idx; pr[psp] = 1; psp++; }
            if (left[n]  >= 0) { pn[psp] = left[n];  pp[psp] = idx; pr[psp] = 0; psp++; }
        }
    }

    free(left); free(right); free(sym); free(leaf); free(nfreq);
    free(h.slots); free(h.freqs);
    free(st_n); free(st_l); free(st_1); free(st_2);
    free(pn); free(pp); free(pr);
    return node_count;
}

/* ------------------------------------------------------------------ */
/* Random-access block kernels (sz_float.c RA variants): per-block     */
/* raster quantize/reconstruct with the kernels' double arithmetic.    */
/* rank in {1,2,3}; bordered recon buffer (bs+1)^rank zeroed per block.*/
/* ------------------------------------------------------------------ */

static inline float ra_reg_pred(const float *q, int nc,
                                int ii, int jj, int kk) {
    if (nc == 4) return q[0]*(float)ii + q[1]*(float)jj + q[2]*(float)kk + q[3];
    if (nc == 3) return q[0]*(float)ii + q[1]*(float)jj + q[2];
    return q[0]*(float)ii + q[1];
}

void ra_encode_blocks_f32(const float *blocks, int64_t nb, int rank, int bs,
                          const uint8_t *lor, const float *qc, int nc,
                          double rp, int cap, int radius,
                          int use_mean, float mean, int32_t *types) {
    int b1 = bs + 1;
    int64_t ncell = 1;
    for (int r = 0; r < rank; r++) ncell *= bs;
    int64_t rsz = 1;
    for (int r = 0; r < rank; r++) rsz *= b1;
    int cap_sz = cap - 2;
    /* blocks are independent (types only; no shared stream) — outputs
     * are disjoint, so the result is thread-count-invariant */
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t b = 0; b < nb; b++) {
        float *R = malloc(rsz * sizeof(float));
        const float *blk = blocks + b * ncell;
        const float *q = qc + b * nc;
        int32_t *tb = types + b * ncell;
        int is_lor = lor[b];
        memset(R, 0, rsz * sizeof(float));
        int64_t ci = 0;
        int ie = rank >= 1 ? bs : 1, je = rank >= 2 ? bs : 1,
            ke = rank >= 3 ? bs : 1;
        /* cells iterate (ii, jj, kk) raster; for rank<3 the trailing
         * loops collapse and the predictor indices shift accordingly */
        for (int ii = 0; ii < ie; ii++)
        for (int jj = 0; jj < je; jj++)
        for (int kk = 0; kk < ke; kk++, ci++) {
            float cur = blk[ci];
            int t; float rec;
            float pred;
            int ccap;
            if (!is_lor) {
                if (rank == 3) pred = ra_reg_pred(q, nc, ii, jj, kk);
                else if (rank == 2) pred = ra_reg_pred(q, nc, ii, jj, 0);
                else pred = ra_reg_pred(q, nc, ii, 0, 0);
                ccap = cap;
            } else {
                if (rank == 3) {
                    const float *Rb = R;
                    int i1 = ii + 1, j1 = jj + 1, k1 = kk + 1;
                    float p = Rb[(i1*b1 + j1)*b1 + k1-1]
                            + Rb[(i1*b1 + j1-1)*b1 + k1];
                    p = p + Rb[((i1-1)*b1 + j1)*b1 + k1];
                    p = p - Rb[(i1*b1 + j1-1)*b1 + k1-1];
                    p = p - Rb[((i1-1)*b1 + j1)*b1 + k1-1];
                    p = p - Rb[((i1-1)*b1 + j1-1)*b1 + k1];
                    p = p + Rb[((i1-1)*b1 + j1-1)*b1 + k1-1];
                    pred = p;
                } else if (rank == 2) {
                    int i1 = ii + 1, j1 = jj + 1;
                    pred = R[i1*b1 + j1-1] + R[(i1-1)*b1 + j1]
                         - R[(i1-1)*b1 + j1-1];
                } else {
                    pred = R[ii];  /* bordered 1D: R[i1-1] with i1=ii+1 */
                }
                ccap = cap_sz;
            }
            {
                float d32 = cur - pred;
                double diff = (double)d32;
                double itv = fabs(diff) / rp + 1.0;
                if (itv < (double)ccap) {
                    if (diff < 0) itv = -itv;
                    t = (int)(itv / 2) + radius;
                    rec = (float)((double)pred
                                  + (double)(2 * (t - radius)) * rp);
                    if (fabs((double)(cur - rec)) > rp) { t = 0; rec = cur; }
                } else { t = 0; rec = cur; }
            }
            if (use_mean && is_lor) {
                if (fabs((double)(cur - mean)) <= rp) { t = 1; rec = mean; }
            }
            tb[ci] = t;
            float stored = is_lor ? rec : cur;
            if (rank == 3)
                R[((ii+1)*b1 + jj+1)*b1 + kk+1] = stored;
            else if (rank == 2)
                R[(ii+1)*b1 + jj+1] = stored;
            else
                R[ii + 1] = stored;
        }
        free(R);
    }
}

void ra_decode_blocks_f32(const int32_t *types, int64_t nsel, int rank, int bs,
                          const uint8_t *lor, const float *qc, int nc,
                          double rp, int radius, int use_mean, float mean,
                          const float *unpred, const int64_t *esc_base,
                          float *out) {
    int b1 = bs + 1;
    int64_t ncell = 1;
    for (int r = 0; r < rank; r++) ncell *= bs;
    int64_t rsz = 1;
    for (int r = 0; r < rank; r++) rsz *= b1;
    /* independent blocks: per-block escape cursors come from esc_base */
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t b = 0; b < nsel; b++) {
        float *R = malloc(rsz * sizeof(float));
        const int32_t *tb = types + b * ncell;
        const float *q = qc + b * nc;
        float *ob = out + b * ncell;
        int is_lor = lor[b];
        int64_t cursor = esc_base[b];
        memset(R, 0, rsz * sizeof(float));
        int64_t ci = 0;
        int ie = rank >= 1 ? bs : 1, je = rank >= 2 ? bs : 1,
            ke = rank >= 3 ? bs : 1;
        for (int ii = 0; ii < ie; ii++)
        for (int jj = 0; jj < je; jj++)
        for (int kk = 0; kk < ke; kk++, ci++) {
            int t = tb[ci];
            float pred;
            if (!is_lor) {
                if (rank == 3) pred = ra_reg_pred(q, nc, ii, jj, kk);
                else if (rank == 2) pred = ra_reg_pred(q, nc, ii, jj, 0);
                else pred = ra_reg_pred(q, nc, ii, 0, 0);
            } else {
                if (rank == 3) {
                    int i1 = ii + 1, j1 = jj + 1, k1 = kk + 1;
                    float p = R[(i1*b1 + j1)*b1 + k1-1]
                            + R[(i1*b1 + j1-1)*b1 + k1];
                    p = p + R[((i1-1)*b1 + j1)*b1 + k1];
                    p = p - R[(i1*b1 + j1-1)*b1 + k1-1];
                    p = p - R[((i1-1)*b1 + j1)*b1 + k1-1];
                    p = p - R[((i1-1)*b1 + j1-1)*b1 + k1];
                    p = p + R[((i1-1)*b1 + j1-1)*b1 + k1-1];
                    pred = p;
                } else if (rank == 2) {
                    int i1 = ii + 1, j1 = jj + 1;
                    pred = R[i1*b1 + j1-1] + R[(i1-1)*b1 + j1]
                         - R[(i1-1)*b1 + j1-1];
                } else {
                    pred = R[ii];
                }
            }
            float val = (float)((double)pred
                                + (double)(2 * (t - radius)) * rp);
            if (use_mean && is_lor && t == 1) val = mean;
            if (t == 0) val = unpred[cursor++];
            ob[ci] = val;
            if (rank == 3)
                R[((ii+1)*b1 + jj+1)*b1 + kk+1] = val;
            else if (rank == 2)
                R[(ii+1)*b1 + jj+1] = val;
            else
                R[ii + 1] = val;
        }
        free(R);
    }
}

/* Batched per-block tree-walk decode: nsel blocks of `count` symbols,
 * block b's bitstream at data + offsets[b] (sizes[b] bytes). */
void huff_tree_decode_blocks(const int32_t *L, const int32_t *R,
                             const int32_t *C, const uint8_t *T,
                             const uint8_t *data, const int64_t *offsets,
                             const uint16_t *sizes, int64_t nsel,
                             int64_t count, int32_t *out) {
#ifdef _OPENMP
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t b = 0; b < nsel; b++)
        huff_tree_decode(L, R, C, T, data + offsets[b], sizes[b],
                         out + b * count, count);
}


/* ------------------------------------------------------------------ */
/* Exact-value escape stream (addExactData dataCompression.c:575,      */
/* updateLossyCompElement CompressElement.c:230) — batched, and the    */
/* classic 1D MDQ kernels built on it.                                 */
/* ------------------------------------------------------------------ */

typedef struct {
    int esize, req_bytes, resi_len;
    uint8_t prev[8];
    uint8_t *lead;  int64_t nlead;
    uint8_t *mid;   int64_t nmid;
    uint8_t *resi;  int64_t nresi;
} xenc;

static inline float xenc_add_f32(xenc *E, float value, float median,
                                 int raw, uint32_t mask) {
    float norm = raw ? value : value - median;
    uint32_t ival;
    memcpy(&ival, &norm, 4);
    uint8_t cur[4] = { (uint8_t)(ival >> 24), (uint8_t)(ival >> 16),
                       (uint8_t)(ival >> 8), (uint8_t)ival };
    uint32_t rbits = ival & mask;
    float recon;
    memcpy(&recon, &rbits, 4);
    if (!raw) recon = recon + median;
    int lead = 0;
    while (lead < 3 && cur[lead] == E->prev[lead]) lead++;
    E->lead[E->nlead++] = (uint8_t)lead;
    for (int b = lead; b < E->req_bytes; b++) E->mid[E->nmid++] = cur[b];
    if (E->resi_len && E->req_bytes < 4)
        E->resi[E->nresi++] = cur[E->req_bytes] >> (8 - E->resi_len);
    memcpy(E->prev, cur, 4);
    return recon;
}

static inline double xenc_add_f64(xenc *E, double value, double median,
                                  int raw, uint64_t mask) {
    double norm = raw ? value : value - median;
    uint64_t ival;
    memcpy(&ival, &norm, 8);
    uint8_t cur[8];
    for (int b = 0; b < 8; b++) cur[b] = (uint8_t)(ival >> (56 - 8 * b));
    uint64_t rbits = ival & mask;
    double recon;
    memcpy(&recon, &rbits, 8);
    if (!raw) recon = recon + median;
    int lead = 0;
    while (lead < 3 && cur[lead] == E->prev[lead]) lead++;
    E->lead[E->nlead++] = (uint8_t)lead;
    for (int b = lead; b < E->req_bytes; b++) E->mid[E->nmid++] = cur[b];
    if (E->resi_len && E->req_bytes < 8)
        E->resi[E->nresi++] = cur[E->req_bytes] >> (8 - E->resi_len);
    memcpy(E->prev, cur, 8);
    return recon;
}

static inline uint64_t xenc_mask(int esize, int req_length) {
    int ign = esize * 8 - req_length;
    if (ign < 0) ign = 0;
    uint64_t full = esize == 4 ? 0xFFFFFFFFull : 0xFFFFFFFFFFFFFFFFull;
    return (~((1ull << ign) - 1ull)) & full;
}

/* Batched escape stream: state passed in/out so Python can interleave
 * batches with its own adds.  prev_io: 8 bytes.  Returns new lead
 * count (== entries appended so far in this call: n). */
void exact_stream_f32(const float *vals, int64_t n, int req_length,
                      float median, int raw, uint8_t *prev_io,
                      uint8_t *lead, uint8_t *mid, int64_t *nmid,
                      uint8_t *resi, float *recon) {
    xenc E;
    E.esize = 4; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 4) E.req_bytes = 4;
    memcpy(E.prev, prev_io, 8);
    E.lead = lead; E.nlead = 0;
    E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint32_t mask = (uint32_t)xenc_mask(4, req_length);
    for (int64_t i = 0; i < n; i++) {
        float r = xenc_add_f32(&E, vals[i], median, raw, mask);
        if (recon) recon[i] = r;
    }
    memcpy(prev_io, E.prev, 8);
    *nmid = E.nmid;
}

void exact_stream_f64(const double *vals, int64_t n, int req_length,
                      double median, int raw, uint8_t *prev_io,
                      uint8_t *lead, uint8_t *mid, int64_t *nmid,
                      uint8_t *resi, double *recon) {
    xenc E;
    E.esize = 8; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 8) E.req_bytes = 8;
    memcpy(E.prev, prev_io, 8);
    E.lead = lead; E.nlead = 0;
    E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint64_t mask = xenc_mask(8, req_length);
    for (int64_t i = 0; i < n; i++) {
        double r = xenc_add_f64(&E, vals[i], median, raw, mask);
        if (recon) recon[i] = r;
    }
    memcpy(prev_io, E.prev, 8);
    *nmid = E.nmid;
}

/* Classic 1D MDQ encode (SZ_compress_float_1D_MDQ sz_float.c:353-524;
 * subblock variant :3444).  Returns the exact-value count. */
int64_t classic1d_encode_f32(const float *x, int64_t n, float rp,
                             double rp64, int intervals, int radius,
                             int req_length, float median, int subblock,
                             int32_t *types, uint8_t *lead, uint8_t *mid,
                             int64_t *nmid, uint8_t *resi) {
    xenc E;
    E.esize = 4; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 4) E.req_bytes = 4;
    memset(E.prev, 0, 8);
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint32_t mask = (uint32_t)xenc_mask(4, req_length);
    float last1 = 0.0f, pred = 0.0f;
    for (int i = 0; i < 2 && i < n; i++) {
        float rec = xenc_add_f32(&E, x[i], median, 0, mask);
        types[i] = 0;
        last1 = pred;
        pred = rec;
    }
    float check_radius = (float)(intervals - 1) * rp;
    float interval2 = 2.0f * rp;
    float recip = 1.0f / rp;
    if (subblock) {
        double check64 = (intervals - 1) * rp64;
        double interval64 = 2.0 * rp64;
        float last0 = pred;
        for (int64_t i = 2; i < n; i++) {
            float cur = x[i];
            float p = 2.0f * last0 - last1;
            float pae = fabsf(cur - p);
            if ((double)pae <= check64) {
                int state = (int)(((double)pae / rp64 + 1.0) / 2.0);
                if (cur >= p) {
                    types[i] = radius + state;
                    p = (float)((double)p + state * interval64);
                } else {
                    types[i] = radius - state;
                    p = (float)((double)p - state * interval64);
                }
                last1 = last0; last0 = p;
            } else {
                types[i] = 0;
                last1 = last0;
                last0 = xenc_add_f32(&E, cur, median, 0, mask);
            }
        }
    } else {
        for (int64_t i = 2; i < n; i++) {
            float cur = x[i];
            float err = fabsf(cur - pred);
            if (err < check_radius) {
                int state = ((int)(err * recip + 1.0f)) >> 1;
                if (cur >= pred) {
                    types[i] = radius + state;
                    pred = pred + (float)state * interval2;
                } else {
                    types[i] = radius - state;
                    pred = pred - (float)state * interval2;
                }
                if (fabsf(cur - pred) > rp) {
                    types[i] = 0;
                    pred = xenc_add_f32(&E, cur, median, 0, mask);
                }
            } else {
                types[i] = 0;
                pred = xenc_add_f32(&E, cur, median, 0, mask);
            }
        }
    }
    *nmid = E.nmid;
    return E.nlead;
}

int64_t classic1d_encode_f64(const double *x, int64_t n, double rp,
                             double rp64, int intervals, int radius,
                             int req_length, double median, int subblock,
                             int32_t *types, uint8_t *lead, uint8_t *mid,
                             int64_t *nmid, uint8_t *resi) {
    xenc E;
    E.esize = 8; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 8) E.req_bytes = 8;
    memset(E.prev, 0, 8);
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint64_t mask = xenc_mask(8, req_length);
    double last1 = 0.0, pred = 0.0;
    for (int i = 0; i < 2 && i < n; i++) {
        double rec = xenc_add_f64(&E, x[i], median, 0, mask);
        types[i] = 0;
        last1 = pred;
        pred = rec;
    }
    double check_radius = (double)(intervals - 1) * rp;
    double interval2 = 2.0 * rp;
    double recip = 1.0 / rp;
    if (subblock) {
        double check64 = (intervals - 1) * rp64;
        double interval64 = 2.0 * rp64;
        double last0 = pred;
        for (int64_t i = 2; i < n; i++) {
            double cur = x[i];
            double p = 2.0 * last0 - last1;
            double pae = fabs(cur - p);
            if (pae <= check64) {
                int state = (int)((pae / rp64 + 1.0) / 2.0);
                if (cur >= p) {
                    types[i] = radius + state;
                    p = p + state * interval64;
                } else {
                    types[i] = radius - state;
                    p = p - state * interval64;
                }
                last1 = last0; last0 = p;
            } else {
                types[i] = 0;
                last1 = last0;
                last0 = xenc_add_f64(&E, cur, median, 0, mask);
            }
        }
    } else {
        for (int64_t i = 2; i < n; i++) {
            double cur = x[i];
            double err = fabs(cur - pred);
            if (err < check_radius) {
                int state = (int)((err * recip + 1.0) * 0.5);
                if (cur >= pred) {
                    types[i] = radius + state;
                    pred = pred + (double)state * interval2;
                } else {
                    types[i] = radius - state;
                    pred = pred - (double)state * interval2;
                }
            } else {
                types[i] = 0;
                pred = xenc_add_f64(&E, cur, median, 0, mask);
            }
        }
    }
    *nmid = E.nmid;
    return E.nlead;
}

/* Classic 1D decode (decompressDataSeries_float_1D szd_float.c:185).
 * lead: unpacked 2-bit values; resi consumed as a bit cursor. */
void classic1d_decode_f32(const int32_t *types, int64_t n, float interval2,
                          int radius, int req_length, float median, int raw,
                          const uint8_t *lead, const uint8_t *mid,
                          const uint8_t *resi, float *out) {
    int req_bytes = req_length / 8, resi_len = req_length % 8;
    if (req_bytes > 4) req_bytes = 4;
    uint8_t prev[4] = {0};
    int64_t midp = 0, bitp = 0;
    float cur = 0.0f;
    for (int64_t i = 0, k = 0; i < n; i++) {
        int t = types[i];
        if (t == 0) {
            uint8_t b[4] = {0};
            int ln = lead[k++];
            for (int j = 0; j < ln; j++) b[j] = prev[j];
            for (int j = ln; j < req_bytes; j++) b[j] = mid[midp++];
            if (resi_len && req_bytes < 4) {
                int v = 0;
                for (int w = 0; w < resi_len; w++) {
                    v = (v << 1) | ((resi[bitp >> 3] >> (7 - (bitp & 7))) & 1);
                    bitp++;
                }
                b[req_bytes] = (uint8_t)(v << (8 - resi_len));
            }
            memcpy(prev, b, 4);
            uint32_t ival = ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16)
                          | ((uint32_t)b[2] << 8) | b[3];
            float val;
            memcpy(&val, &ival, 4);
            cur = raw ? val : val + median;
        } else {
            cur = cur + (float)(t - radius) * interval2;
        }
        out[i] = cur;
    }
}

void classic1d_decode_f64(const int32_t *types, int64_t n, double interval2,
                          int radius, int req_length, double median, int raw,
                          const uint8_t *lead, const uint8_t *mid,
                          const uint8_t *resi, double *out) {
    int req_bytes = req_length / 8, resi_len = req_length % 8;
    if (req_bytes > 8) req_bytes = 8;
    uint8_t prev[8] = {0};
    int64_t midp = 0, bitp = 0;
    double cur = 0.0;
    for (int64_t i = 0, k = 0; i < n; i++) {
        int t = types[i];
        if (t == 0) {
            uint8_t b[8] = {0};
            int ln = lead[k++];
            for (int j = 0; j < ln; j++) b[j] = prev[j];
            for (int j = ln; j < req_bytes; j++) b[j] = mid[midp++];
            if (resi_len && req_bytes < 8) {
                int v = 0;
                for (int w = 0; w < resi_len; w++) {
                    v = (v << 1) | ((resi[bitp >> 3] >> (7 - (bitp & 7))) & 1);
                    bitp++;
                }
                b[req_bytes] = (uint8_t)(v << (8 - resi_len));
            }
            memcpy(prev, b, 8);
            uint64_t ival = 0;
            for (int j = 0; j < 8; j++) ival = (ival << 8) | b[j];
            double val;
            memcpy(&val, &ival, 8);
            cur = raw ? val : val + median;
        } else {
            cur = cur + (double)(t - radius) * interval2;
        }
        out[i] = cur;
    }
}

/* Random-access coefficient chain (sz_float.c:9677-9712): double
 * division with float last values — distinct from the regnd float
 * chain above. */
void ra_coeff_chain_f32(const float *coeffs, int64_t nreg, int nc,
                        const double *prec, int cap, int radius,
                        int32_t *ctypes, float *unpred, int64_t *ucnt,
                        float *qcoeffs) {
    float last[8] = {0};
    for (int e = 0; e < nc; e++) ucnt[e] = 0;
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            float cur = coeffs[n * nc + e];
            double diff = (double)(cur - last[e]);
            double itv = fabs(diff) / prec[e] + 1.0;
            if (itv < (double)cap) {
                if (diff < 0) itv = -itv;
                int t = (int)(itv / 2) + radius;
                float rec = (float)((double)last[e]
                                    + (double)(2 * (t - radius)) * prec[e]);
                if (fabs((double)(cur - rec)) > prec[e]) {
                    ctypes[e * nreg + n] = 0;
                    last[e] = cur;
                    unpred[e * nreg + ucnt[e]++] = cur;
                } else {
                    ctypes[e * nreg + n] = t;
                    last[e] = rec;
                }
            } else {
                ctypes[e * nreg + n] = 0;
                last[e] = cur;
                unpred[e * nreg + ucnt[e]++] = cur;
            }
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

void ra_coeff_chain_decode_f32(const int32_t *ctypes, int64_t nreg, int nc,
                               const double *prec, const int32_t *radius,
                               const float *unpred_flat, const int64_t *off,
                               float *qcoeffs) {
    float last[8] = {0};
    int64_t cur[8];
    for (int e = 0; e < nc; e++) cur[e] = off[e];
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            int32_t t = ctypes[e * nreg + n];
            if (t != 0)
                last[e] = (float)((double)last[e]
                                  + (double)(2 * (t - radius[e])) * prec[e]);
            else
                last[e] = unpred_flat[cur[e]++];
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

/* ------------------------------------------------------------------ */
/* MSST19 multiplicative kernels (SZ_compress_float_{1,2,3}D_MDQ_MSST19*/
/* sz_float.c:1824+, decompressDataSeries_*_MSST19 szd_float.c) —      */
/* statement-level ports of the Python oracle loops in core/pwr.py.    */
/* ------------------------------------------------------------------ */

static inline int msst19_lookup(double ratio, const uint16_t *table,
                                int64_t base_index, int64_t top_index,
                                int bits, int64_t row_size) {
    uint64_t b;
    memcpy(&b, &ratio, 8);
    int64_t expo = (int64_t)((b & 0x7FFFFFFFFFFFFFFFull) >> 52)
                   - base_index;
    if (expo < 0 || expo > top_index - base_index) return 0;
    uint64_t manti = (b & 0x000FFFFFFFFFFFFFull) >> (52 - bits);
    return table[expo * row_size + manti];
}

/* rank in {1,2,3}; for rank<3 pass r1=1 (and r2=1 for rank 1) so the
 * volume is (r1, r2, r3) with r3 fastest.  Float chains: 2D kernels
 * chain in float, 3D kernels route products through double temps
 * (sz_float.c MSST19) — controlled by `rank`.  Returns escape count. */
int64_t msst19_encode_f32(const float *x, int rank, int64_t r1,
                          int64_t r2, int64_t r3,
                          const uint16_t *table, int64_t base_index,
                          int64_t top_index, int bits, int64_t row_size,
                          const double *ptable, int req_length,
                          int32_t *types, uint8_t *lead, uint8_t *mid,
                          int64_t *nmid, uint8_t *resi) {
    xenc E;
    E.esize = 4; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 4) E.req_bytes = 4;
    memset(E.prev, 0, 8);
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint32_t mask = (uint32_t)xenc_mask(4, req_length);
    int64_t n = r1 * r2 * r3;
    int64_t r23 = r2 * r3;

#define Q32(cur_, pred_, out_)                                          \
    do {                                                                \
        float ratio_ = (cur_) / (pred_);                                \
        int st_ = msst19_lookup((double)ratio_, table, base_index,      \
                                top_index, bits, row_size);             \
        if (st_) {                                                      \
            types[idx_] = st_;                                          \
            (out_) = (float)(fabs((double)(pred_)) * ptable[st_]);      \
        } else {                                                        \
            types[idx_] = 0;                                            \
            (out_) = xenc_add_f32(&E, (cur_), 0.0f, 1, mask);           \
        }                                                               \
    } while (0)

    if (rank == 1) {
        int64_t idx_ = 0;
        types[0] = 0;
        float pred = xenc_add_f32(&E, x[0], 0.0f, 1, mask);
        (void)pred;
        types[1] = 0;
        pred = xenc_add_f32(&E, x[1], 0.0f, 1, mask);
        for (int64_t i = 2; i < n; i++) {
            float cur = x[i];
            float ratio = cur / pred;
            int st = msst19_lookup((double)ratio, table, base_index,
                                   top_index, bits, row_size);
            if (st) {
                types[i] = st;
                pred = (float)((double)pred * ptable[st]);
            } else {
                types[i] = 0;
                pred = xenc_add_f32(&E, cur, 0.0f, 1, mask);
            }
        }
        *nmid = E.nmid;
        return E.nlead;
    }

    float *P1 = malloc(r23 * sizeof(float));
    float *P0 = malloc(r23 * sizeof(float));
    if (rank == 2) {
        /* 2D float kernel: float product chains */
        int64_t idx_ = 0;
        types[0] = 0;
        P1[0] = xenc_add_f32(&E, x[0], 0.0f, 1, mask);
        idx_ = 1;
        Q32(x[1], P1[0], P1[1]);
        for (int64_t j = 2; j < r3; j++) {
            float pred = (float)(P1[j-1] * P1[j-1]) / P1[j-2];
            idx_ = j;
            Q32(x[j], pred, P1[j]);
        }
        for (int64_t i = 1; i < r2; i++) {
            int64_t base = i * r3;
            idx_ = base;
            Q32(x[base], P1[0], P0[0]);
            for (int64_t j = 1; j < r3; j++) {
                float pred = (float)(P0[j-1] * P1[j]) / P1[j-1];
                idx_ = base + j;
                Q32(x[base+j], pred, P0[j]);
            }
            float *t = P1; P1 = P0; P0 = t;
        }
    } else {
        /* 3D float kernel: double temps throughout */
        int64_t idx_ = 0;
        types[0] = 0;
        P1[0] = xenc_add_f32(&E, x[0], 0.0f, 1, mask);
        idx_ = 1;
        Q32(x[1], P1[0], P1[1]);
        for (int64_t j = 2; j < r3; j++) {
            float pred = (float)((double)P1[j-1] * (double)P1[j-1]
                                 / (double)P1[j-2]);
            idx_ = j;
            Q32(x[j], pred, P1[j]);
        }
        for (int64_t i = 1; i < r2; i++) {
            int64_t ix = i * r3;
            idx_ = ix;
            Q32(x[ix], P1[ix - r3], P1[ix]);
            for (int64_t j = 1; j < r3; j++) {
                int64_t c = ix + j;
                float pred = (float)((double)P1[c-1] * (double)P1[c-r3]
                                     / (double)P1[c-r3-1]);
                idx_ = c;
                Q32(x[c], pred, P1[c]);
            }
        }
        for (int64_t k = 1; k < r1; k++) {
            int64_t index = k * r23;
            idx_ = index;
            Q32(x[index], P1[0], P0[0]);
            for (int64_t j = 1; j < r3; j++) {
                index++;
                float pred = (float)((double)P0[j-1] * (double)P1[j]
                                     / (double)P1[j-1]);
                idx_ = index;
                Q32(x[index], pred, P0[j]);
            }
            for (int64_t i = 1; i < r2; i++) {
                index = k * r23 + i * r3;
                int64_t i2 = i * r3;
                float pred = (float)((double)P0[i2-r3] * (double)P1[i2]
                                     / (double)P1[i2-r3]);
                idx_ = index;
                Q32(x[index], pred, P0[i2]);
                for (int64_t j = 1; j < r3; j++) {
                    index++;
                    i2 = i * r3 + j;
                    double num = (double)P0[i2-1] * (double)P0[i2-r3]
                               * (double)P1[i2] * (double)P1[i2-r3-1];
                    double den = (double)P0[i2-r3-1] * (double)P1[i2-r3]
                               * (double)P1[i2-1];
                    float pred2 = (float)(num / den);
                    idx_ = index;
                    Q32(x[index], pred2, P0[i2]);
                }
            }
            float *t = P1; P1 = P0; P0 = t;
        }
    }
#undef Q32
    free(P1); free(P0);
    *nmid = E.nmid;
    return E.nlead;
}

int64_t msst19_encode_f64(const double *x, int rank, int64_t r1,
                          int64_t r2, int64_t r3,
                          const uint16_t *table, int64_t base_index,
                          int64_t top_index, int bits, int64_t row_size,
                          const double *ptable, int req_length,
                          int32_t *types, uint8_t *lead, uint8_t *mid,
                          int64_t *nmid, uint8_t *resi) {
    xenc E;
    E.esize = 8; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 8) E.req_bytes = 8;
    memset(E.prev, 0, 8);
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint64_t mask = xenc_mask(8, req_length);
    int64_t n = r1 * r2 * r3;
    int64_t r23 = r2 * r3;

#define Q64(cur_, pred_, out_)                                          \
    do {                                                                \
        double ratio_ = (cur_) / (pred_);                               \
        int st_ = msst19_lookup(ratio_, table, base_index,              \
                                top_index, bits, row_size);             \
        if (st_) {                                                      \
            types[idx_] = st_;                                          \
            (out_) = fabs(pred_) * ptable[st_];                         \
        } else {                                                        \
            types[idx_] = 0;                                            \
            (out_) = xenc_add_f64(&E, (cur_), 0.0, 1, mask);            \
        }                                                               \
    } while (0)

    if (rank == 1) {
        types[0] = 0;
        double pred = xenc_add_f64(&E, x[0], 0.0, 1, mask);
        types[1] = 0;
        pred = xenc_add_f64(&E, x[1], 0.0, 1, mask);
        for (int64_t i = 2; i < n; i++) {
            double cur = x[i];
            int st = msst19_lookup(cur / pred, table, base_index,
                                   top_index, bits, row_size);
            if (st) {
                types[i] = st;
                pred = pred * ptable[st];
            } else {
                types[i] = 0;
                pred = xenc_add_f64(&E, cur, 0.0, 1, mask);
            }
        }
        *nmid = E.nmid;
        return E.nlead;
    }

    double *P1 = malloc(r23 * sizeof(double));
    double *P0 = malloc(r23 * sizeof(double));
    if (rank == 2) {
        int64_t idx_ = 0;
        types[0] = 0;
        P1[0] = xenc_add_f64(&E, x[0], 0.0, 1, mask);
        idx_ = 1;
        Q64(x[1], P1[0], P1[1]);
        for (int64_t j = 2; j < r3; j++) {
            double pred = P1[j-1] * P1[j-1] / P1[j-2];
            idx_ = j;
            Q64(x[j], pred, P1[j]);
        }
        for (int64_t i = 1; i < r2; i++) {
            int64_t base = i * r3;
            idx_ = base;
            Q64(x[base], P1[0], P0[0]);
            for (int64_t j = 1; j < r3; j++) {
                double pred = P0[j-1] * P1[j] / P1[j-1];
                idx_ = base + j;
                Q64(x[base+j], pred, P0[j]);
            }
            double *t = P1; P1 = P0; P0 = t;
        }
    } else {
        int64_t idx_ = 0;
        types[0] = 0;
        P1[0] = xenc_add_f64(&E, x[0], 0.0, 1, mask);
        idx_ = 1;
        Q64(x[1], P1[0], P1[1]);
        for (int64_t j = 2; j < r3; j++) {
            double pred = P1[j-1] * P1[j-1] / P1[j-2];
            idx_ = j;
            Q64(x[j], pred, P1[j]);
        }
        for (int64_t i = 1; i < r2; i++) {
            int64_t ix = i * r3;
            idx_ = ix;
            Q64(x[ix], P1[ix - r3], P1[ix]);
            for (int64_t j = 1; j < r3; j++) {
                int64_t c = ix + j;
                double pred = P1[c-1] * P1[c-r3] / P1[c-r3-1];
                idx_ = c;
                Q64(x[c], pred, P1[c]);
            }
        }
        for (int64_t k = 1; k < r1; k++) {
            int64_t index = k * r23;
            idx_ = index;
            Q64(x[index], P1[0], P0[0]);
            for (int64_t j = 1; j < r3; j++) {
                index++;
                double pred = P0[j-1] * P1[j] / P1[j-1];
                idx_ = index;
                Q64(x[index], pred, P0[j]);
            }
            for (int64_t i = 1; i < r2; i++) {
                index = k * r23 + i * r3;
                int64_t i2 = i * r3;
                double pred = P0[i2-r3] * P1[i2] / P1[i2-r3];
                idx_ = index;
                Q64(x[index], pred, P0[i2]);
                for (int64_t j = 1; j < r3; j++) {
                    index++;
                    i2 = i * r3 + j;
                    double num = P0[i2-1] * P0[i2-r3] * P1[i2]
                               * P1[i2-r3-1];
                    double den = P0[i2-r3-1] * P1[i2-r3] * P1[i2-1];
                    idx_ = index;
                    Q64(x[index], num / den, P0[i2]);
                }
            }
            double *t = P1; P1 = P0; P0 = t;
        }
    }
#undef Q64
    free(P1); free(P0);
    *nmid = E.nmid;
    return E.nlead;
}

/* Exact-stream reader state for the decode kernels. */
typedef struct {
    int esize, req_bytes, resi_len;
    uint8_t prev[8];
    const uint8_t *lead;  int64_t k;
    const uint8_t *mid;   int64_t midp;
    const uint8_t *resi;  int64_t bitp;
} xdec;

static inline float xdec_next_f32(xdec *D, float median, int raw) {
    uint8_t b[4] = {0};
    int ln = D->lead[D->k++];
    for (int j = 0; j < ln; j++) b[j] = D->prev[j];
    for (int j = ln; j < D->req_bytes; j++) b[j] = D->mid[D->midp++];
    if (D->resi_len && D->req_bytes < 4) {
        int v = 0;
        for (int w = 0; w < D->resi_len; w++) {
            v = (v << 1)
              | ((D->resi[D->bitp >> 3] >> (7 - (D->bitp & 7))) & 1);
            D->bitp++;
        }
        b[D->req_bytes] = (uint8_t)(v << (8 - D->resi_len));
    }
    memcpy(D->prev, b, 4);
    uint32_t ival = ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16)
                  | ((uint32_t)b[2] << 8) | b[3];
    float val;
    memcpy(&val, &ival, 4);
    return raw ? val : val + median;
}

static inline double xdec_next_f64(xdec *D, double median, int raw) {
    uint8_t b[8] = {0};
    int ln = D->lead[D->k++];
    for (int j = 0; j < ln; j++) b[j] = D->prev[j];
    for (int j = ln; j < D->req_bytes; j++) b[j] = D->mid[D->midp++];
    if (D->resi_len && D->req_bytes < 8) {
        int v = 0;
        for (int w = 0; w < D->resi_len; w++) {
            v = (v << 1)
              | ((D->resi[D->bitp >> 3] >> (7 - (D->bitp & 7))) & 1);
            D->bitp++;
        }
        b[D->req_bytes] = (uint8_t)(v << (8 - D->resi_len));
    }
    memcpy(D->prev, b, 8);
    uint64_t ival = 0;
    for (int j = 0; j < 8; j++) ival = (ival << 8) | b[j];
    double val;
    memcpy(&val, &ival, 8);
    return raw ? val : val + median;
}

void msst19_decode_f32(const int32_t *types, int rank, int64_t r1,
                       int64_t r2, int64_t r3, const double *ptable,
                       int req_length, const uint8_t *lead,
                       const uint8_t *mid, const uint8_t *resi,
                       float *out) {
    xdec D;
    D.esize = 4; D.req_bytes = req_length / 8; D.resi_len = req_length % 8;
    if (D.req_bytes > 4) D.req_bytes = 4;
    memset(D.prev, 0, 8);
    D.lead = lead; D.k = 0; D.mid = mid; D.midp = 0;
    D.resi = resi; D.bitp = 0;
    int64_t n = r1 * r2 * r3;
    int64_t r23 = r2 * r3;

#define R32(idx_, pred_)                                                \
    do {                                                                \
        int t_ = types[idx_];                                           \
        out[idx_] = t_ ? (float)(fabs((double)(pred_)) * ptable[t_])    \
                       : xdec_next_f32(&D, 0.0f, 1);                    \
    } while (0)

    if (rank == 1) {
        R32(0, 0.0f);
        for (int64_t i = 1; i < n; i++) R32(i, out[i-1]);
    } else if (rank == 2) {
        R32(0, 0.0f);
        R32(1, out[0]);
        for (int64_t j = 2; j < r3; j++)
            R32(j, (float)(out[j-1] * out[j-1]) / out[j-2]);
        for (int64_t i = 1; i < r2; i++) {
            int64_t base = i * r3;
            R32(base, out[base - r3]);
            for (int64_t j = 1; j < r3; j++) {
                int64_t ix = base + j;
                R32(ix, (float)(out[ix-1] * out[ix-r3]) / out[ix-r3-1]);
            }
        }
    } else {
        R32(0, 0.0f);
        R32(1, out[0]);
        for (int64_t j = 2; j < r3; j++)
            R32(j, (float)((double)out[j-1] * (double)out[j-1]
                           / (double)out[j-2]));
        for (int64_t i = 1; i < r2; i++) {
            int64_t ix = i * r3;
            R32(ix, out[ix - r3]);
            for (int64_t j = 1; j < r3; j++) {
                int64_t c = ix + j;
                R32(c, (float)((double)out[c-1] * (double)out[c-r3]
                               / (double)out[c-r3-1]));
            }
        }
        for (int64_t k = 1; k < r1; k++) {
            int64_t index = k * r23;
            R32(index, out[index - r23]);
            for (int64_t j = 1; j < r3; j++) {
                int64_t c = index + j;
                R32(c, (float)((double)out[c-1] * (double)out[c-r23]
                               / (double)out[c-r23-1]));
            }
            for (int64_t i = 1; i < r2; i++) {
                int64_t c = index + i * r3;
                R32(c, (float)((double)out[c-r3] * (double)out[c-r23]
                               / (double)out[c-r23-r3]));
                for (int64_t j = 1; j < r3; j++) {
                    c++;
                    double num = (double)out[c-1] * (double)out[c-r3]
                               * (double)out[c-r23]
                               * (double)out[c-r23-r3-1];
                    double den = (double)out[c-r3-1]
                               * (double)out[c-r23-r3]
                               * (double)out[c-r23-1];
                    R32(c, (float)(num / den));
                }
            }
        }
    }
#undef R32
}

void msst19_decode_f64(const int32_t *types, int rank, int64_t r1,
                       int64_t r2, int64_t r3, const double *ptable,
                       int req_length, const uint8_t *lead,
                       const uint8_t *mid, const uint8_t *resi,
                       double *out) {
    xdec D;
    D.esize = 8; D.req_bytes = req_length / 8; D.resi_len = req_length % 8;
    if (D.req_bytes > 8) D.req_bytes = 8;
    memset(D.prev, 0, 8);
    D.lead = lead; D.k = 0; D.mid = mid; D.midp = 0;
    D.resi = resi; D.bitp = 0;
    int64_t n = r1 * r2 * r3;
    int64_t r23 = r2 * r3;

#define R64(idx_, pred_)                                                \
    do {                                                                \
        int t_ = types[idx_];                                           \
        out[idx_] = t_ ? fabs(pred_) * ptable[t_]                       \
                       : xdec_next_f64(&D, 0.0, 1);                     \
    } while (0)

    if (rank == 1) {
        R64(0, 0.0);
        for (int64_t i = 1; i < n; i++) R64(i, out[i-1]);
    } else if (rank == 2) {
        R64(0, 0.0);
        R64(1, out[0]);
        for (int64_t j = 2; j < r3; j++)
            R64(j, out[j-1] * out[j-1] / out[j-2]);
        for (int64_t i = 1; i < r2; i++) {
            int64_t base = i * r3;
            R64(base, out[base - r3]);
            for (int64_t j = 1; j < r3; j++) {
                int64_t ix = base + j;
                R64(ix, out[ix-1] * out[ix-r3] / out[ix-r3-1]);
            }
        }
    } else {
        R64(0, 0.0);
        R64(1, out[0]);
        for (int64_t j = 2; j < r3; j++)
            R64(j, out[j-1] * out[j-1] / out[j-2]);
        for (int64_t i = 1; i < r2; i++) {
            int64_t ix = i * r3;
            R64(ix, out[ix - r3]);
            for (int64_t j = 1; j < r3; j++) {
                int64_t c = ix + j;
                R64(c, out[c-1] * out[c-r3] / out[c-r3-1]);
            }
        }
        for (int64_t k = 1; k < r1; k++) {
            int64_t index = k * r23;
            R64(index, out[index - r23]);
            for (int64_t j = 1; j < r3; j++) {
                int64_t c = index + j;
                R64(c, out[c-1] * out[c-r23] / out[c-r23-1]);
            }
            for (int64_t i = 1; i < r2; i++) {
                int64_t c = index + i * r3;
                R64(c, out[c-r3] * out[c-r23] / out[c-r23-r3]);
                for (int64_t j = 1; j < r3; j++) {
                    c++;
                    double num = out[c-1] * out[c-r3] * out[c-r23]
                               * out[c-r23-r3-1];
                    double den = out[c-r3-1] * out[c-r23-r3]
                               * out[c-r23-1];
                    R64(c, num / den);
                }
            }
        }
    }
#undef R64
}

/* One-pass MSST19 range/sign scan (computeRangeSize_*_MSST19).
 * signs[0] stays 0; near starts at x[0], strictly-smaller nonzero
 * magnitudes update it (first occurrence wins).  Returns positive. */
int range_scan_f32(const float *x, int64_t n, uint8_t *signs,
                   float *fmin, float *fmax, float *near) {
    int positive = 1;
    float mn = x[0], mx = x[0], nr = x[0];
    signs[0] = 0;
    for (int64_t i = 1; i < n; i++) {
        float v = x[i];
        int s = v < 0;
        signs[i] = (uint8_t)s;
        if (s) positive = 0;
        if (v < mn) mn = v;
        if (v > mx) mx = v;
        if (v != 0 && fabsf(v) < fabsf(nr)) nr = v;
    }
    *fmin = mn; *fmax = mx; *near = nr;
    return positive;
}

int range_scan_f64(const double *x, int64_t n, uint8_t *signs,
                   double *fmin, double *fmax, double *near) {
    int positive = 1;
    double mn = x[0], mx = x[0], nr = x[0];
    signs[0] = 0;
    for (int64_t i = 1; i < n; i++) {
        double v = x[i];
        int s = v < 0;
        signs[i] = (uint8_t)s;
        if (s) positive = 0;
        if (v < mn) mn = v;
        if (v > mx) mx = v;
        if (v != 0 && fabs(v) < fabs(nr)) nr = v;
    }
    *fmin = mn; *fmax = mx; *near = nr;
    return positive;
}

/* Histogram of int32 codes; returns -1 if any value is out of
 * [0, nbins) (caller falls back to np.bincount's extending semantics). */
int64_t i32_hist(const int32_t *x, int64_t n, int64_t *hist,
                 int64_t nbins) {
    for (int64_t i = 0; i < n; i++) {
        int32_t v = x[i];
        if (v < 0 || v >= nbins) return -1;
        hist[v]++;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* SZ2.1 blocked-regression point kernels                              */
/* (SZ_compress_float_2D/3D_MDQ_nonblocked_with_blocked_regression,    */
/* sz_float.c:5516/6527 and the szd_float.c decoders) — ports of the   */
/* per-point oracle loops in core/regnd.py (rolling boundary strips    */
/* on encode, direct lattice reads on decode).                         */
/* ------------------------------------------------------------------ */

#define GEN_REGND(SUF, FT, FABS)                                        \
static inline int quant_point_##SUF(FT cur, FT pred, FT rp, FT recip,   \
                                    FT cap, int radius, FT *rec) {      \
    FT diff = cur - pred;                                               \
    FT itv = FABS(diff) * recip + (FT)1;                                \
    if (itv < cap) {                                                    \
        if (diff < 0) itv = -itv;                                       \
        int t = (int)(itv / (FT)2) + radius;                            \
        FT rc = pred + (FT)(2 * (t - radius)) * rp;                     \
        if (FABS(cur - rc) > rp) { *rec = cur; return 0; }              \
        *rec = rc;                                                      \
        return t;                                                       \
    }                                                                   \
    *rec = cur;                                                         \
    return 0;                                                           \
}                                                                       \
                                                                        \
int64_t regnd_encode3d_##SUF(                                           \
    const FT *data, int64_t r1, int64_t r2, int64_t r3,                 \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    const int64_t *zo, const int64_t *zc, int64_t nbz,                  \
    int64_t bx_early, const uint8_t *use_reg, const FT *qcoeffs,        \
    FT rp, FT recip, int intervals, int use_mean, FT mean,              \
    int32_t *result_type, FT *unpred) {                                 \
    FT cap = (FT)intervals, cap_sz = (FT)(intervals - 2);               \
    int radius = intervals / 2;                                         \
    int64_t s1 = (r2 + 1) * (r3 + 1);                                   \
    FT *strip = calloc((bx_early + 1) * s1, sizeof(FT));                \
    FT *nstrip = calloc((bx_early + 1) * s1, sizeof(FT));               \
    int64_t ucnt = 0, qn = 0;                                           \
    for (int64_t i = 0; i < nbx; i++) {                                 \
        int64_t cbx = xc[i], ox = xo[i];                                \
        for (int64_t j = 0; j < nby; j++) {                             \
            int64_t cby = yc[j], oy = yo[j];                            \
            int64_t tpos = ox * r2 * r3 + oy * cbx * r3;                \
            for (int64_t k = 0; k < nbz; k++) {                         \
                int64_t cbz = zc[k], oz = zo[k];                        \
                int64_t bidx = (i * nby + j) * nbz + k;                 \
                if (use_reg[bidx]) {                                    \
                    const FT *lc = qcoeffs + qn * 4;                    \
                    qn++;                                               \
                    for (int64_t ii = 0; ii < cbx; ii++)                \
                    for (int64_t jj = 0; jj < cby; jj++)                \
                    for (int64_t kk = 0; kk < cbz; kk++) {              \
                        FT cur = data[(ox+ii)*r2*r3 + (oy+jj)*r3         \
                                      + oz+kk];                         \
                        FT pred = lc[0]*(FT)ii + lc[1]*(FT)jj           \
                                + lc[2]*(FT)kk + lc[3];                 \
                        FT rec;                                         \
                        int t = quant_point_##SUF(cur, pred, rp, recip, \
                                                  cap, radius, &rec);   \
                        if (t == 0) unpred[ucnt++] = cur;               \
                        result_type[tpos + (ii*cby + jj)*cbz + kk] = t; \
                        if (jj == cby-1 || kk == cbz-1)                 \
                            strip[(ii+1)*s1 + (oy+jj+1)*(r3+1)          \
                                  + oz+kk+1] = rec;                     \
                        if (ii == cbx-1)                                \
                            nstrip[(oy+jj+1)*(r3+1) + oz+kk+1] = rec;   \
                    }                                                   \
                } else {                                                \
                    for (int64_t ii = 0; ii < cbx; ii++)                \
                    for (int64_t jj = 0; jj < cby; jj++)                \
                    for (int64_t kk = 0; kk < cbz; kk++) {              \
                        FT cur = data[(ox+ii)*r2*r3 + (oy+jj)*r3         \
                                      + oz+kk];                         \
                        FT rec;                                         \
                        int t;                                          \
                        if (use_mean && FABS(cur - mean) <= rp) {       \
                            t = radius;                                 \
                            rec = mean;                                 \
                        } else {                                        \
                            int64_t sx = ii+1, sy = oy+jj+1,            \
                                    sz = oz+kk+1;                       \
                            FT p = strip[sx*s1 + sy*(r3+1) + sz-1]      \
                                 + strip[sx*s1 + (sy-1)*(r3+1) + sz];   \
                            p = p + strip[(sx-1)*s1 + sy*(r3+1) + sz];  \
                            p = p - strip[sx*s1 + (sy-1)*(r3+1)+sz-1];  \
                            p = p - strip[(sx-1)*s1 + sy*(r3+1)+sz-1];  \
                            p = p - strip[(sx-1)*s1+(sy-1)*(r3+1)+sz];  \
                            p = p + strip[(sx-1)*s1+(sy-1)*(r3+1)       \
                                          +sz-1];                       \
                            t = quant_point_##SUF(cur, p, rp, recip,    \
                                                  cap_sz, radius,       \
                                                  &rec);                \
                            if (use_mean && t != 0 && t <= radius)      \
                                t -= 1;                                 \
                        }                                               \
                        if (t == 0) unpred[ucnt++] = cur;               \
                        result_type[tpos + (ii*cby + jj)*cbz + kk] = t; \
                        strip[(ii+1)*s1 + (oy+jj+1)*(r3+1)              \
                              + oz+kk+1] = rec;                         \
                        if (ii == cbx-1)                                \
                            nstrip[(oy+jj+1)*(r3+1) + oz+kk+1] = rec;   \
                    }                                                   \
                }                                                       \
                tpos += cbx * cby * cbz;                                \
            }                                                           \
        }                                                               \
        FT *t_ = strip; strip = nstrip; nstrip = t_;                    \
    }                                                                   \
    free(strip); free(nstrip);                                          \
    return ucnt;                                                        \
}                                                                       \
                                                                        \
int64_t regnd_encode2d_##SUF(                                           \
    const FT *data, int64_t r1, int64_t r2,                             \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    int64_t bx_early, const uint8_t *use_reg, const FT *qcoeffs,        \
    FT rp, FT recip, int intervals, int use_mean, FT mean,              \
    int32_t *result_type, FT *unpred) {                                 \
    FT cap = (FT)intervals, cap_sz = (FT)(intervals - 2);               \
    int radius = intervals / 2;                                         \
    int64_t s1 = r2 + 1;                                                \
    FT *strip = calloc((bx_early + 1) * s1, sizeof(FT));                \
    FT *nstrip = calloc((bx_early + 1) * s1, sizeof(FT));               \
    int64_t ucnt = 0, qn = 0;                                           \
    (void)use_mean; (void)mean;                                         \
    for (int64_t i = 0; i < nbx; i++) {                                 \
        int64_t cbx = xc[i], ox = xo[i];                                \
        int64_t tpos = ox * r2;                                         \
        for (int64_t j = 0; j < nby; j++) {                             \
            int64_t cby = yc[j], oy = yo[j];                            \
            int64_t bidx = i * nby + j;                                 \
            if (use_reg[bidx]) {                                        \
                const FT *lc = qcoeffs + qn * 3;                        \
                qn++;                                                   \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++) {                  \
                    FT cur = data[(ox+ii)*r2 + oy+jj];                  \
                    FT pred = lc[0]*(FT)ii + lc[1]*(FT)jj + lc[2];      \
                    FT rec;                                             \
                    int t = quant_point_##SUF(cur, pred, rp, recip,     \
                                              cap, radius, &rec);      \
                    if (t == 0) unpred[ucnt++] = cur;                   \
                    result_type[tpos + ii*cby + jj] = t;                \
                    if (jj == cby-1)                                    \
                        strip[(ii+1)*s1 + oy+jj+1] = rec;               \
                    if (ii == cbx-1) nstrip[oy+jj+1] = rec;             \
                }                                                       \
            } else {                                                    \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++) {                  \
                    FT cur = data[(ox+ii)*r2 + oy+jj];                  \
                    int64_t sx = ii+1, sy = oy+jj+1;                    \
                    FT p = strip[sx*s1 + sy-1] + strip[(sx-1)*s1 + sy]  \
                         - strip[(sx-1)*s1 + sy-1];                     \
                    FT rec;                                             \
                    int t = quant_point_##SUF(cur, p, rp, recip,        \
                                              cap_sz, radius, &rec);   \
                    if (t == 0) unpred[ucnt++] = cur;                   \
                    result_type[tpos + ii*cby + jj] = t;                \
                    strip[(ii+1)*s1 + oy+jj+1] = rec;                   \
                    if (ii == cbx-1) nstrip[oy+jj+1] = rec;             \
                }                                                       \
            }                                                           \
            tpos += cbx * cby;                                          \
        }                                                               \
        FT *t_ = strip; strip = nstrip; nstrip = t_;                    \
    }                                                                   \
    free(strip); free(nstrip);                                          \
    return ucnt;                                                        \
}                                                                       \
                                                                        \
void regnd_decode3d_##SUF(                                              \
    const int32_t *types, int64_t r1, int64_t r2, int64_t r3,           \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    const int64_t *zo, const int64_t *zc, int64_t nbz,                  \
    const uint8_t *indicator, const FT *qcoeffs, const FT *unpred,      \
    FT rp, int intervals, int use_mean, FT mean, FT *out) {             \
    int radius = intervals / 2;                                         \
    int64_t tpos = 0, upos = 0, qn = 0, blk = 0;                        \
    for (int64_t i = 0; i < nbx; i++) {                                 \
        int64_t cbx = xc[i], ox = xo[i];                                \
        for (int64_t j = 0; j < nby; j++) {                             \
            int64_t cby = yc[j], oy = yo[j];                            \
            for (int64_t k = 0; k < nbz; k++) {                         \
                int64_t cbz = zc[k], oz = zo[k];                        \
                if (indicator[blk]) {                                   \
                    for (int64_t ii = 0; ii < cbx; ii++)                \
                    for (int64_t jj = 0; jj < cby; jj++)                \
                    for (int64_t kk = 0; kk < cbz; kk++) {              \
                        int t = types[tpos + (ii*cby + jj)*cbz + kk];   \
                        int64_t x = ox+ii, y = oy+jj, z = oz+kk;        \
                        int64_t c = x*r2*r3 + y*r3 + z;                 \
                        if (use_mean && t == radius) {                  \
                            out[c] = mean;                              \
                        } else if (t == 0) {                            \
                            out[c] = unpred[upos++];                    \
                        } else {                                        \
                            FT d110 = z ? out[c-1] : (FT)0;             \
                            FT d101 = y ? out[c-r3] : (FT)0;            \
                            FT d011 = x ? out[c-r2*r3] : (FT)0;         \
                            FT d100 = (y && z) ? out[c-r3-1] : (FT)0;   \
                            FT d010 = (x && z) ? out[c-r2*r3-1]         \
                                               : (FT)0;                 \
                            FT d001 = (x && y) ? out[c-r2*r3-r3]        \
                                               : (FT)0;                 \
                            FT d000 = (x && y && z)                     \
                                      ? out[c-r2*r3-r3-1] : (FT)0;      \
                            if (use_mean && t < radius) t += 1;         \
                            FT p = d110 + d101;                         \
                            p = p + d011;                               \
                            p = p - d100;                               \
                            p = p - d010;                               \
                            p = p - d001;                               \
                            p = p + d000;                               \
                            out[c] = p + (FT)(2 * (t - radius)) * rp;   \
                        }                                               \
                    }                                                   \
                } else {                                                \
                    const FT *lc = qcoeffs + qn * 4;                    \
                    qn++;                                               \
                    for (int64_t ii = 0; ii < cbx; ii++)                \
                    for (int64_t jj = 0; jj < cby; jj++)                \
                    for (int64_t kk = 0; kk < cbz; kk++) {              \
                        int t = types[tpos + (ii*cby + jj)*cbz + kk];   \
                        int64_t c = (ox+ii)*r2*r3 + (oy+jj)*r3 + oz+kk; \
                        if (t != 0) {                                   \
                            FT pred = lc[0]*(FT)ii + lc[1]*(FT)jj       \
                                    + lc[2]*(FT)kk + lc[3];             \
                            out[c] = pred + (FT)(2 * (t - radius)) * rp;\
                        } else {                                        \
                            out[c] = unpred[upos++];                    \
                        }                                               \
                    }                                                   \
                }                                                       \
                tpos += cbx * cby * cbz;                                \
                blk++;                                                  \
            }                                                           \
        }                                                               \
    }                                                                   \
}                                                                       \
                                                                        \
void regnd_decode2d_##SUF(                                              \
    const int32_t *types, int64_t r1, int64_t r2,                       \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    const uint8_t *indicator, const FT *qcoeffs, const FT *unpred,      \
    FT rp, int intervals, int use_mean, FT mean, FT *out) {             \
    int radius = intervals / 2;                                         \
    int64_t tpos = 0, upos = 0, qn = 0, blk = 0;                        \
    (void)use_mean; (void)mean;                                         \
    for (int64_t i = 0; i < nbx; i++) {                                 \
        int64_t cbx = xc[i], ox = xo[i];                                \
        for (int64_t j = 0; j < nby; j++) {                             \
            int64_t cby = yc[j], oy = yo[j];                            \
            if (indicator[blk]) {                                       \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++) {                  \
                    int t = types[tpos + ii*cby + jj];                  \
                    int64_t x = ox+ii, y = oy+jj;                       \
                    int64_t c = x*r2 + y;                               \
                    if (use_mean && t == radius) {                      \
                        out[c] = mean;                                  \
                    } else if (t == 0) {                                \
                        out[c] = unpred[upos++];                        \
                    } else {                                            \
                        FT d10 = y ? out[c-1] : (FT)0;                  \
                        FT d01 = x ? out[c-r2] : (FT)0;                 \
                        FT d00 = (x && y) ? out[c-r2-1] : (FT)0;        \
                        if (use_mean && t < radius) t += 1;             \
                        FT p = d10 + d01 - d00;                         \
                        out[c] = p + (FT)(2 * (t - radius)) * rp;       \
                    }                                                   \
                }                                                       \
            } else {                                                    \
                const FT *lc = qcoeffs + qn * 3;                        \
                qn++;                                                   \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++) {                  \
                    int t = types[tpos + ii*cby + jj];                  \
                    int64_t c = (ox+ii)*r2 + oy+jj;                     \
                    if (t != 0) {                                       \
                        FT pred = lc[0]*(FT)ii + lc[1]*(FT)jj + lc[2];  \
                        out[c] = pred + (FT)(2 * (t - radius)) * rp;    \
                    } else {                                            \
                        out[c] = unpred[upos++];                        \
                    }                                                   \
                }                                                       \
            }                                                           \
            tpos += cbx * cby;                                          \
            blk++;                                                      \
        }                                                               \
    }                                                                   \
}

GEN_REGND(f32, float, fabsf)
GEN_REGND(f64, double, fabs)
#undef GEN_REGND

/* ------------------------------------------------------------------ */
/* Classic SZ1.4 2D/3D/4D MDQ kernels                                  */
/* (SZ_compress_float_2D/3D/4D_MDQ sz_float.c:610/946/1479 + double    */
/* analogs; decoders szd_float.c:284/600/1140) — ports of the          */
/* per-point oracle loops in core/classic_nd.py.  2D runs as a         */
/* single-layer 3D volume (identical scheme); 4D as independent        */
/* slices.  `dbl` selects the float-4D/double itvNum+recon arithmetic. */
/* ------------------------------------------------------------------ */

#define GEN_CLASSIC(SUF, FT, FABS, ESIZE, XADD)                         \
static FT cnd_quant_##SUF(xenc *E, int32_t *types, int64_t idx, FT cur, \
                          FT pred, double rp64, double recip64,         \
                          FT rp, FT recip, int intervals, int radius,   \
                          int dbl, FT median, uint64_t mask) {          \
    FT diff = cur - pred;                                               \
    if (dbl) {                                                          \
        double itv = fabs((double)diff) * recip64 + 1.0;                \
        if (itv < (double)intervals) {                                  \
            if (diff < 0) itv = -itv;                                   \
            int t = (int)(itv / 2.0) + radius;                          \
            FT rec = (FT)((double)pred                                  \
                          + (double)(2 * (t - radius)) * rp64);         \
            if (fabs((double)(FT)(cur - rec)) > rp64) {                 \
                types[idx] = 0;                                         \
                return XADD(E, cur, median, 0, mask);                   \
            }                                                           \
            types[idx] = t;                                             \
            return rec;                                                 \
        }                                                               \
    } else {                                                            \
        FT itv = (FT)(fabs((double)diff) * (double)recip + 1.0);        \
        if (itv < (FT)intervals) {                                      \
            if (diff < 0) itv = -itv;                                   \
            int t = (int)(itv / (FT)2) + radius;                        \
            FT rec = pred + (FT)(2 * (t - radius)) * rp;                \
            if (fabs((double)(FT)(cur - rec)) > (double)rp) {           \
                types[idx] = 0;                                         \
                return XADD(E, cur, median, 0, mask);                   \
            }                                                           \
            types[idx] = t;                                             \
            return rec;                                                 \
        }                                                               \
    }                                                                   \
    types[idx] = 0;                                                     \
    return XADD(E, cur, median, 0, mask);                               \
}                                                                       \
                                                                        \
int64_t classicnd_encode_##SUF(const FT *x, int64_t q1, int64_t r1,     \
                               int64_t r2, int64_t r3, double rp64,     \
                               double recip64, FT rp, FT recip,         \
                               int intervals, int radius, int dbl,      \
                               int req_length, FT median,               \
                               int32_t *types, uint8_t *lead,           \
                               uint8_t *mid, int64_t *nmid,             \
                               uint8_t *resi) {                         \
    xenc E;                                                             \
    E.esize = ESIZE;                                                    \
    E.req_bytes = req_length / 8; E.resi_len = req_length % 8;          \
    if (E.req_bytes > ESIZE) E.req_bytes = ESIZE;                       \
    memset(E.prev, 0, 8);                                               \
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;                \
    E.resi = resi; E.nresi = 0;                                         \
    uint64_t mask = xenc_mask(ESIZE, req_length);                       \
    int64_t r23 = r2 * r3;                                              \
    int64_t vol = r1 * r23;                                             \
    FT *P1 = malloc(r23 * sizeof(FT));                                  \
    FT *P0 = malloc(r23 * sizeof(FT));                                  \
    for (int64_t l = 0; l < q1; l++) {                                  \
        int64_t base = l * vol;                                         \
        types[base] = 0;                                                \
        P1[0] = XADD(&E, x[base], median, 0, mask);                     \
        if (r3 > 1)                                                     \
            P1[1] = cnd_quant_##SUF(&E, types, base + 1, x[base + 1],   \
                                    P1[0], rp64, recip64, rp, recip,    \
                                    intervals, radius, dbl, median,     \
                                    mask);                              \
        for (int64_t j = 2; j < r3; j++) {                              \
            FT pred = (FT)2 * P1[j-1] - P1[j-2];                        \
            P1[j] = cnd_quant_##SUF(&E, types, base + j, x[base + j],   \
                                    pred, rp64, recip64, rp, recip,     \
                                    intervals, radius, dbl, median,     \
                                    mask);                              \
        }                                                               \
        for (int64_t i = 1; i < r2; i++) {                              \
            int64_t ix = i * r3;                                        \
            P1[ix] = cnd_quant_##SUF(&E, types, base + ix, x[base + ix],\
                                     P1[ix - r3], rp64, recip64, rp,    \
                                     recip, intervals, radius, dbl,     \
                                     median, mask);                     \
            for (int64_t j = 1; j < r3; j++) {                          \
                int64_t c = ix + j;                                     \
                FT pred = P1[c-1] + P1[c-r3] - P1[c-r3-1];              \
                P1[c] = cnd_quant_##SUF(&E, types, base + c,            \
                                        x[base + c], pred, rp64,        \
                                        recip64, rp, recip, intervals,  \
                                        radius, dbl, median, mask);     \
            }                                                           \
        }                                                               \
        for (int64_t k = 1; k < r1; k++) {                              \
            int64_t index = k * r23;                                    \
            P0[0] = cnd_quant_##SUF(&E, types, base + index,            \
                                    x[base + index], P1[0], rp64,       \
                                    recip64, rp, recip, intervals,      \
                                    radius, dbl, median, mask);         \
            for (int64_t j = 1; j < r3; j++) {                          \
                index++;                                                \
                FT pred = P0[j-1] + P1[j] - P1[j-1];                    \
                P0[j] = cnd_quant_##SUF(&E, types, base + index,        \
                                        x[base + index], pred, rp64,    \
                                        recip64, rp, recip, intervals,  \
                                        radius, dbl, median, mask);     \
            }                                                           \
            for (int64_t i = 1; i < r2; i++) {                          \
                index = k * r23 + i * r3;                               \
                int64_t i2 = i * r3;                                    \
                FT pred = P0[i2-r3] + P1[i2] - P1[i2-r3];               \
                P0[i2] = cnd_quant_##SUF(&E, types, base + index,       \
                                         x[base + index], pred, rp64,   \
                                         recip64, rp, recip, intervals, \
                                         radius, dbl, median, mask);    \
                for (int64_t j = 1; j < r3; j++) {                      \
                    index++;                                            \
                    i2 = i * r3 + j;                                    \
                    FT pred2 = P0[i2-1] + P0[i2-r3];                    \
                    pred2 = pred2 + P1[i2];                             \
                    pred2 = pred2 - P0[i2-r3-1];                        \
                    pred2 = pred2 - P1[i2-r3];                          \
                    pred2 = pred2 - P1[i2-1];                           \
                    pred2 = pred2 + P1[i2-r3-1];                        \
                    P0[i2] = cnd_quant_##SUF(&E, types, base + index,   \
                                             x[base + index], pred2,    \
                                             rp64, recip64, rp, recip,  \
                                             intervals, radius, dbl,    \
                                             median, mask);             \
                }                                                       \
            }                                                           \
            FT *t_ = P1; P1 = P0; P0 = t_;                              \
        }                                                               \
    }                                                                   \
    free(P1); free(P0);                                                 \
    *nmid = E.nmid;                                                     \
    return E.nlead;                                                     \
}

GEN_CLASSIC(f32, float, fabsf, 4, xenc_add_f32)
GEN_CLASSIC(f64, double, fabs, 8, xenc_add_f64)
#undef GEN_CLASSIC

#define GEN_CLASSIC_DEC(SUF, FT, XNEXT, ESIZE)                         \
static inline void cnd_rec_##SUF(xdec *D, const int32_t *ty, FT *o,     \
                                 int64_t idx, FT pred, double rp64,     \
                                 FT rp, int radius, int dbl,            \
                                 FT median) {                           \
    int t = ty[idx];                                                    \
    if (t == 0) o[idx] = XNEXT(D, median, 0);                           \
    else if (dbl)                                                       \
        o[idx] = (FT)((double)pred                                      \
                      + (double)(2 * (t - radius)) * rp64);             \
    else                                                                \
        o[idx] = pred + (FT)(2 * (t - radius)) * rp;                    \
}                                                                       \
                                                                        \
void classicnd_decode_##SUF(const int32_t *types, int64_t q1,           \
                            int64_t r1, int64_t r2, int64_t r3,         \
                            double rp64, FT rp, int radius, int dbl,    \
                            int req_length, FT median,                  \
                            const uint8_t *lead, const uint8_t *mid,    \
                            const uint8_t *resi, FT *out) {             \
    xdec D;                                                             \
    D.esize = ESIZE;                                                    \
    D.req_bytes = req_length / 8; D.resi_len = req_length % 8;          \
    if (D.req_bytes > ESIZE) D.req_bytes = ESIZE;                       \
    memset(D.prev, 0, 8);                                               \
    D.lead = lead; D.k = 0; D.mid = mid; D.midp = 0;                    \
    D.resi = resi; D.bitp = 0;                                          \
    int64_t r23 = r2 * r3;                                              \
    int64_t vol = r1 * r23;                                             \
    for (int64_t l = 0; l < q1; l++) {                                  \
        FT *o = out + l * vol;                                          \
        const int32_t *ty = types + l * vol;                            \
        cnd_rec_##SUF(&D, ty, o, 0, (FT)0, rp64, rp, radius, dbl,       \
                      median);                                          \
        if (r3 > 1)                                                     \
            cnd_rec_##SUF(&D, ty, o, 1, o[0], rp64, rp, radius, dbl,    \
                          median);                                      \
        for (int64_t j = 2; j < r3; j++)                                \
            cnd_rec_##SUF(&D, ty, o, j, (FT)2 * o[j-1] - o[j-2],        \
                          rp64, rp, radius, dbl, median);               \
        for (int64_t i = 1; i < r2; i++) {                              \
            int64_t ix = i * r3;                                        \
            cnd_rec_##SUF(&D, ty, o, ix, o[ix - r3], rp64, rp, radius,  \
                          dbl, median);                                 \
            for (int64_t j = 1; j < r3; j++) {                          \
                int64_t c = ix + j;                                     \
                cnd_rec_##SUF(&D, ty, o, c,                             \
                              o[c-1] + o[c-r3] - o[c-r3-1], rp64, rp,   \
                              radius, dbl, median);                     \
            }                                                           \
        }                                                               \
        for (int64_t k = 1; k < r1; k++) {                              \
            int64_t index = k * r23;                                    \
            cnd_rec_##SUF(&D, ty, o, index, o[index - r23], rp64, rp,   \
                          radius, dbl, median);                         \
            for (int64_t j = 1; j < r3; j++) {                          \
                int64_t c = index + j;                                  \
                cnd_rec_##SUF(&D, ty, o, c,                             \
                              o[c-1] + o[c-r23] - o[c-r23-1], rp64,     \
                              rp, radius, dbl, median);                 \
            }                                                           \
            for (int64_t i = 1; i < r2; i++) {                          \
                int64_t c = index + i * r3;                             \
                cnd_rec_##SUF(&D, ty, o, c,                             \
                              o[c-r3] + o[c-r23] - o[c-r23-r3], rp64,   \
                              rp, radius, dbl, median);                 \
                for (int64_t j = 1; j < r3; j++) {                      \
                    int64_t cj = c + j;                                 \
                    FT pred = o[cj-1] + o[cj-r3];                       \
                    pred = pred + o[cj-r23];                            \
                    pred = pred - o[cj-r3-1];                           \
                    pred = pred - o[cj-r23-r3];                         \
                    pred = pred - o[cj-r23-1];                          \
                    pred = pred + o[cj-r23-r3-1];                       \
                    cnd_rec_##SUF(&D, ty, o, cj, pred, rp64, rp,        \
                                  radius, dbl, median);                 \
                }                                                       \
            }                                                           \
        }                                                               \
    }                                                                   \
}

GEN_CLASSIC_DEC(f32, float, xdec_next_f32, 4)
GEN_CLASSIC_DEC(f64, double, xdec_next_f64, 8)
#undef GEN_CLASSIC_DEC

/* ------------------------------------------------------------------ */
/* Integer 2D/3D/4D MDQ kernels (sz_[u]int*.c) — ports of the Python   */
/* oracle loops in core/intc.py with the per-width arithmetic quirks   */
/* (AN/DN wrap widths, double->int truncation, the 4D stale-curValue   */
/* bug).  2D runs as a single-layer 3D volume; 4D as slices with the   \
 * quirk step at position 1 of every slice.                            */
/* ------------------------------------------------------------------ */

static inline int64_t wrap_bits(int64_t v, int bits, int sgn) {
    if (bits >= 64) return v;
    uint64_t m = (~0ull) >> (64 - bits);
    uint64_t u = (uint64_t)v & m;
    if (sgn && (u >> (bits - 1))) return (int64_t)(u | ~m);
    return (int64_t)u;
}

static inline int64_t ld_int(const uint8_t *p, int esize, int sgn) {
    switch (esize) {
        case 1: return sgn ? (int64_t)*(const int8_t *)p
                           : (int64_t)*(const uint8_t *)p;
        case 2: return sgn ? (int64_t)*(const int16_t *)p
                           : (int64_t)*(const uint16_t *)p;
        case 4: return sgn ? (int64_t)*(const int32_t *)p
                           : (int64_t)*(const uint32_t *)p;
        default: return *(const int64_t *)p;
    }
}

typedef struct {
    double rp;
    int intervals, radius;
    int an_bits, an_sgn, dn_bits;
    int64_t min_value;
    int byte_size, store_esize;
    uint8_t *exact;
    int64_t ecnt;     /* exact VALUE count */
} ienc;

static inline void ienc_store(ienc *E, int64_t value) {
    uint64_t m = (E->store_esize >= 8) ? ~0ull
                 : ((~0ull) >> (64 - 8 * E->store_esize));
    uint64_t d = ((uint64_t)(value - E->min_value)) & m;
    for (int b = 0; b < E->byte_size; b++)
        E->exact[E->ecnt * E->byte_size + b] =
            (uint8_t)(d >> (8 * (E->byte_size - 1 - b)));
    E->ecnt++;
}

/* One quant step: cur as the (wrapped-to-input) int64 value; returns
 * the new AN-wrapped prediction and writes types[idx]. */
static inline int64_t ienc_quant(ienc *E, int32_t *types, int64_t idx,
                                 int64_t cur, int64_t pred) {
    int64_t diff = wrap_bits(cur - pred, E->dn_bits, 1);
    double itv = (double)(diff < 0 ? -diff : diff) / E->rp + 1.0;
    if (itv < (double)E->intervals) {
        if (diff < 0) itv = -itv;
        int t = (int)(itv / 2) + E->radius;
        types[idx] = t;
        double v = (double)pred + 2.0 * (t - E->radius) * E->rp;
        return wrap_bits((int64_t)trunc(v), E->an_bits, E->an_sgn);
    }
    types[idx] = 0;
    ienc_store(E, cur);
    return wrap_bits(cur, E->an_bits, E->an_sgn);
}

int64_t intnd_encode2(const uint8_t *x, int in_esize, int in_sgn,
                      int64_t q1, int64_t r1, int64_t r2, int64_t r3,
                      double rp, int intervals, int radius,
                      int an_bits, int an_sgn, int dn_bits,
                      int64_t min_value, int byte_size, int store_esize,
                      int quirk4d, int32_t *types, uint8_t *exact) {
    ienc E;
    E.rp = rp; E.intervals = intervals; E.radius = radius;
    E.an_bits = an_bits; E.an_sgn = an_sgn; E.dn_bits = dn_bits;
    E.min_value = min_value; E.byte_size = byte_size;
    E.store_esize = store_esize;
    E.exact = exact; E.ecnt = 0;
    int64_t r23 = r2 * r3;
    int64_t vol = r1 * r23;
    int64_t *P1 = malloc(r23 * sizeof(int64_t));
    int64_t *P0 = malloc(r23 * sizeof(int64_t));
    int64_t global_first = ld_int(x, in_esize, in_sgn);

#define LD(i_) ld_int(x + (i_) * in_esize, in_esize, in_sgn)

    for (int64_t l = 0; l < q1; l++) {
        int64_t base = l * vol;
        /* first element always exact */
        types[base] = 0;
        ienc_store(&E, LD(base));
        P1[0] = wrap_bits(LD(base), an_bits, an_sgn);
        if (r3 > 1) {
            if (quirk4d) {
                /* 4D "Row-0 data 1" bug: diff uses the slice's element
                 * 0 as curValue; its escape stores the GLOBAL first */
                int64_t stale = LD(base);
                int64_t diff = wrap_bits(stale - P1[0], dn_bits, 1);
                double itv = (double)(diff < 0 ? -diff : diff) / rp
                             + 1.0;
                if (itv < (double)intervals) {
                    if (diff < 0) itv = -itv;
                    int t = (int)(itv / 2) + radius;
                    types[base + 1] = t;
                    double v = (double)P1[0]
                               + 2.0 * (t - radius) * rp;
                    P1[1] = wrap_bits((int64_t)trunc(v), an_bits,
                                      an_sgn);
                } else {
                    types[base + 1] = 0;
                    ienc_store(&E, global_first);
                    P1[1] = wrap_bits(global_first, an_bits, an_sgn);
                }
            } else {
                P1[1] = ienc_quant(&E, types, base + 1, LD(base + 1),
                                   P1[0]);
            }
        }
        for (int64_t j = 2; j < r3; j++)
            P1[j] = ienc_quant(&E, types, base + j, LD(base + j),
                               wrap_bits(2 * P1[j-1] - P1[j-2],
                                         an_bits, an_sgn));
        for (int64_t i = 1; i < r2; i++) {
            int64_t ix = i * r3;
            P1[ix] = ienc_quant(&E, types, base + ix, LD(base + ix),
                                P1[ix - r3]);
            for (int64_t j = 1; j < r3; j++) {
                int64_t c = ix + j;
                P1[c] = ienc_quant(&E, types, base + c, LD(base + c),
                                   wrap_bits(P1[c-1] + P1[c-r3]
                                             - P1[c-r3-1],
                                             an_bits, an_sgn));
            }
        }
        for (int64_t k = 1; k < r1; k++) {
            int64_t index = k * r23;
            P0[0] = ienc_quant(&E, types, base + index, LD(base + index),
                               P1[0]);
            for (int64_t j = 1; j < r3; j++) {
                index++;
                P0[j] = ienc_quant(&E, types, base + index,
                                   LD(base + index),
                                   wrap_bits(P0[j-1] + P1[j] - P1[j-1],
                                             an_bits, an_sgn));
            }
            for (int64_t i = 1; i < r2; i++) {
                index = k * r23 + i * r3;
                int64_t i2 = i * r3;
                P0[i2] = ienc_quant(&E, types, base + index,
                                    LD(base + index),
                                    wrap_bits(P0[i2-r3] + P1[i2]
                                              - P1[i2-r3],
                                              an_bits, an_sgn));
                for (int64_t j = 1; j < r3; j++) {
                    index++;
                    i2 = i * r3 + j;
                    int64_t pred = P0[i2-1] + P0[i2-r3] + P1[i2]
                                 - P0[i2-r3-1] - P1[i2-r3] - P1[i2-1]
                                 + P1[i2-r3-1];
                    P0[i2] = ienc_quant(&E, types, base + index,
                                        LD(base + index),
                                        wrap_bits(pred, an_bits,
                                                  an_sgn));
                }
            }
            int64_t *t_ = P1; P1 = P0; P0 = t_;
        }
    }
#undef LD
    free(P1); free(P0);
    return E.ecnt;
}

void intnd_decode(const int32_t *types, int64_t q1, int64_t r1,
                  int64_t r2, int64_t r3, double interval2, int radius,
                  int t_bits, int t_sgn, int64_t min_value,
                  int byte_size, int store_esize, const uint8_t *exact,
                  int64_t *out) {
    int64_t r23 = r2 * r3;
    int64_t vol = r1 * r23;
    int64_t epos = 0;
    uint64_t mask = (store_esize >= 8) ? ~0ull
                    : ((~0ull) >> (64 - 8 * store_esize));

#define INXT(dst_)                                                      \
    do {                                                                \
        uint64_t v_ = 0;                                                \
        for (int b_ = 0; b_ < byte_size; b_++)                          \
            v_ = (v_ << 8) | exact[epos++];                             \
        v_ = (v_ + (uint64_t)min_value) & mask;                         \
        (dst_) = wrap_bits((int64_t)v_, t_bits, t_sgn);                 \
    } while (0)

#define IREC(idx_, pred_)                                               \
    do {                                                                \
        int t_ = types[idx_];                                           \
        if (t_ == 0) INXT(o[idx_]);                                     \
        else o[idx_] = wrap_bits(                                       \
            (int64_t)trunc((double)(pred_)                              \
                           + (t_ - radius) * interval2),                \
            t_bits, t_sgn);                                             \
    } while (0)

    for (int64_t l = 0; l < q1; l++) {
        int64_t *o = out + l * vol;
        const int32_t *ty = types + l * vol;
        (void)ty;
        int64_t *types_off = NULL; (void)types_off;
        /* use absolute indices into o with types offset via macro: */
        {
            const int32_t *types_l = types + l * vol;
            /* shadow types for IREC */
            #define types types_l
            IREC(0, (int64_t)0);
            if (r3 > 1) IREC(1, o[0]);
            for (int64_t j = 2; j < r3; j++)
                IREC(j, 2 * o[j-1] - o[j-2]);
            for (int64_t i = 1; i < r2; i++) {
                int64_t ix = i * r3;
                IREC(ix, o[ix - r3]);
                for (int64_t j = 1; j < r3; j++) {
                    int64_t c = ix + j;
                    IREC(c, o[c-1] + o[c-r3] - o[c-r3-1]);
                }
            }
            for (int64_t k = 1; k < r1; k++) {
                int64_t index = k * r23;
                IREC(index, o[index - r23]);
                for (int64_t j = 1; j < r3; j++) {
                    int64_t c = index + j;
                    IREC(c, o[c-1] + o[c-r23] - o[c-r23-1]);
                }
                for (int64_t i = 1; i < r2; i++) {
                    int64_t c = index + i * r3;
                    IREC(c, o[c-r3] + o[c-r23] - o[c-r23-r3]);
                    for (int64_t j = 1; j < r3; j++) {
                        int64_t cj = c + j;
                        int64_t pred = o[cj-1] + o[cj-r3] + o[cj-r23]
                                     - o[cj-r3-1] - o[cj-r23-r3]
                                     - o[cj-r23-1] + o[cj-r23-r3-1];
                        IREC(cj, pred);
                    }
                }
            }
            #undef types
        }
    }
#undef IREC
#undef INXT
}

/* ------------------------------------------------------------------ */
/* sz_omp RA_block kernels (SZ_compress_float_3D_MDQ_RA_block          */
/* sz_float.c:4704, double sz_double.c:4396 as used by sz_omp.c):      */
/* the classic scheme, block-local, first element quantized against    */
/* itself (the "mean" seed) and RAW escape values.  `dbl` selects the  */
/* double kernels' arithmetic.                                         */
/* ------------------------------------------------------------------ */

#define GEN_OMPB(SUF, FT)                                               \
static inline FT ompb_quant_##SUF(int32_t *types, int64_t idx, FT cur,  \
                                  FT pred, double rp64, double recip64, \
                                  FT rp, int intervals, int radius,     \
                                  int dbl, FT *unpred, int64_t *ucnt) { \
    FT diff = cur - pred;                                               \
    if (dbl) {                                                          \
        double itv = fabs((double)diff) * recip64 + 1.0;                \
        if (itv < (double)intervals) {                                  \
            if (diff < 0) itv = -itv;                                   \
            int t = (int)(itv / 2.0) + radius;                          \
            FT rec = (FT)((double)pred                                  \
                          + (double)(2 * (t - radius)) * rp64);         \
            if (!(fabs((double)(FT)(cur - rec)) > rp64)) {              \
                types[idx] = t;                                         \
                return rec;                                             \
            }                                                           \
        }                                                               \
    } else {                                                            \
        FT itv = (FT)(fabs((double)diff) * recip64 + 1.0);              \
        if (itv < (FT)intervals) {                                      \
            if (diff < 0) itv = -itv;                                   \
            int t = (int)(itv / (FT)2) + radius;                        \
            FT rec = pred + (FT)(2 * (t - radius)) * rp;                \
            if (!(fabs((double)(FT)(cur - rec)) > rp64)) {              \
                types[idx] = t;                                         \
                return rec;                                             \
            }                                                           \
        }                                                               \
    }                                                                   \
    types[idx] = 0;                                                     \
    unpred[(*ucnt)++] = cur;                                            \
    return cur;                                                         \
}                                                                       \
                                                                        \
int64_t ompblock_encode_##SUF(const FT *x, int64_t r1, int64_t r2,      \
                              int64_t r3, double rp64, double recip64,  \
                              FT rp, int intervals, int radius,         \
                              int dbl, int32_t *types, FT *unpred) {    \
    int64_t r23 = r2 * r3;                                              \
    FT *P1 = malloc(r23 * sizeof(FT));                                  \
    FT *P0 = malloc(r23 * sizeof(FT));                                  \
    int64_t ucnt = 0;                                                   \
    P1[0] = ompb_quant_##SUF(types, 0, x[0], x[0], rp64, recip64, rp,   \
                             intervals, radius, dbl, unpred, &ucnt);    \
    if (r3 > 1)                                                         \
        P1[1] = ompb_quant_##SUF(types, 1, x[1], P1[0], rp64, recip64,  \
                                 rp, intervals, radius, dbl, unpred,    \
                                 &ucnt);                                \
    for (int64_t j = 2; j < r3; j++) {                                  \
        FT pred = (FT)2 * P1[j-1] - P1[j-2];                            \
        P1[j] = ompb_quant_##SUF(types, j, x[j], pred, rp64, recip64,   \
                                 rp, intervals, radius, dbl, unpred,    \
                                 &ucnt);                                \
    }                                                                   \
    for (int64_t i = 1; i < r2; i++) {                                  \
        int64_t ix = i * r3;                                            \
        P1[ix] = ompb_quant_##SUF(types, ix, x[ix], P1[ix - r3], rp64,  \
                                  recip64, rp, intervals, radius, dbl,  \
                                  unpred, &ucnt);                       \
        for (int64_t j = 1; j < r3; j++) {                              \
            int64_t c = ix + j;                                         \
            FT pred = P1[c-1] + P1[c-r3] - P1[c-r3-1];                  \
            P1[c] = ompb_quant_##SUF(types, c, x[c], pred, rp64,        \
                                     recip64, rp, intervals, radius,    \
                                     dbl, unpred, &ucnt);               \
        }                                                               \
    }                                                                   \
    for (int64_t k = 1; k < r1; k++) {                                  \
        int64_t index = k * r23;                                        \
        P0[0] = ompb_quant_##SUF(types, index, x[index], P1[0], rp64,   \
                                 recip64, rp, intervals, radius, dbl,   \
                                 unpred, &ucnt);                        \
        for (int64_t j = 1; j < r3; j++) {                              \
            index++;                                                    \
            FT pred = P0[j-1] + P1[j] - P1[j-1];                        \
            P0[j] = ompb_quant_##SUF(types, index, x[index], pred,      \
                                     rp64, recip64, rp, intervals,      \
                                     radius, dbl, unpred, &ucnt);       \
        }                                                               \
        for (int64_t i = 1; i < r2; i++) {                              \
            index = k * r23 + i * r3;                                   \
            int64_t i2 = i * r3;                                        \
            FT pred = P0[i2-r3] + P1[i2] - P1[i2-r3];                   \
            P0[i2] = ompb_quant_##SUF(types, index, x[index], pred,     \
                                      rp64, recip64, rp, intervals,     \
                                      radius, dbl, unpred, &ucnt);      \
            for (int64_t j = 1; j < r3; j++) {                          \
                index++;                                                \
                i2 = i * r3 + j;                                        \
                FT pred2 = P0[i2-1] + P0[i2-r3];                        \
                pred2 = pred2 + P1[i2];                                 \
                pred2 = pred2 - P0[i2-r3-1];                            \
                pred2 = pred2 - P1[i2-r3];                              \
                pred2 = pred2 - P1[i2-1];                               \
                pred2 = pred2 + P1[i2-r3-1];                            \
                P0[i2] = ompb_quant_##SUF(types, index, x[index],       \
                                          pred2, rp64, recip64, rp,     \
                                          intervals, radius, dbl,       \
                                          unpred, &ucnt);               \
            }                                                           \
        }                                                               \
        FT *t_ = P1; P1 = P0; P0 = t_;                                  \
    }                                                                   \
    free(P1); free(P0);                                                 \
    return ucnt;                                                        \
}                                                                       \
                                                                        \
static inline void ompb_rec_##SUF(const int32_t *ty, FT *o,             \
                                  int64_t idx, FT pred, double rp64,    \
                                  FT rp, int radius, int dbl,           \
                                  const FT *unpred, int64_t *up) {      \
    int t = ty[idx];                                                    \
    if (t == 0) { o[idx] = unpred[(*up)++]; return; }                   \
    if (dbl)                                                            \
        o[idx] = (FT)((double)pred                                      \
                      + (double)(2 * (t - radius)) * rp64);             \
    else                                                                \
        o[idx] = pred + (FT)(2 * (t - radius)) * rp;                    \
}                                                                       \
                                                                        \
void ompblock_decode_##SUF(const int32_t *ty, int64_t r1, int64_t r2,   \
                           int64_t r3, FT mean, double rp64, FT rp,     \
                           int radius, int dbl, const FT *unpred,       \
                           FT *o) {                                     \
    int64_t r23 = r2 * r3;                                              \
    int64_t up = 0;                                                     \
    ompb_rec_##SUF(ty, o, 0, mean, rp64, rp, radius, dbl, unpred, &up); \
    if (r3 > 1)                                                         \
        ompb_rec_##SUF(ty, o, 1, o[0], rp64, rp, radius, dbl, unpred,   \
                       &up);                                            \
    for (int64_t j = 2; j < r3; j++)                                    \
        ompb_rec_##SUF(ty, o, j, (FT)2 * o[j-1] - o[j-2], rp64, rp,     \
                       radius, dbl, unpred, &up);                       \
    for (int64_t i = 1; i < r2; i++) {                                  \
        int64_t ix = i * r3;                                            \
        ompb_rec_##SUF(ty, o, ix, o[ix - r3], rp64, rp, radius, dbl,    \
                       unpred, &up);                                    \
        for (int64_t j = 1; j < r3; j++) {                              \
            int64_t c = ix + j;                                         \
            ompb_rec_##SUF(ty, o, c, o[c-1] + o[c-r3] - o[c-r3-1],      \
                           rp64, rp, radius, dbl, unpred, &up);         \
        }                                                               \
    }                                                                   \
    for (int64_t k = 1; k < r1; k++) {                                  \
        int64_t index = k * r23;                                        \
        ompb_rec_##SUF(ty, o, index, o[index - r23], rp64, rp, radius,  \
                       dbl, unpred, &up);                               \
        for (int64_t j = 1; j < r3; j++) {                              \
            int64_t c = index + j;                                      \
            ompb_rec_##SUF(ty, o, c, o[c-1] + o[c-r23] - o[c-r23-1],    \
                           rp64, rp, radius, dbl, unpred, &up);         \
        }                                                               \
        for (int64_t i = 1; i < r2; i++) {                              \
            int64_t c = index + i * r3;                                 \
            ompb_rec_##SUF(ty, o, c,                                    \
                           o[c-r3] + o[c-r23] - o[c-r23-r3], rp64, rp,  \
                           radius, dbl, unpred, &up);                   \
            for (int64_t j = 1; j < r3; j++) {                          \
                int64_t cj = c + j;                                     \
                FT pred = o[cj-1] + o[cj-r3];                           \
                pred = pred + o[cj-r23];                                \
                pred = pred - o[cj-r3-1];                               \
                pred = pred - o[cj-r23-r3];                             \
                pred = pred - o[cj-r23-1];                              \
                pred = pred + o[cj-r23-r3-1];                           \
                ompb_rec_##SUF(ty, o, cj, pred, rp64, rp, radius, dbl,  \
                               unpred, &up);                            \
            }                                                           \
        }                                                               \
    }                                                                   \
}

GEN_OMPB(f32, float)
GEN_OMPB(f64, double)
#undef GEN_OMPB

/* Integer 1D MDQ encode (SZ_compress_intXX_1D_MDQ, e.g. sz_int32.c:228)
 * for arbitrary bounds: serial prediction chain with the A1 wrap
 * width.  First two values always exact. */
int64_t int1d_encode(const uint8_t *x, int in_esize, int in_sgn,
                     int64_t n, double rp, int intervals, int radius,
                     int a1_bits, int a1_sgn, int64_t min_value,
                     int byte_size, int store_esize, int32_t *types,
                     uint8_t *exact) {
    ienc E;
    E.rp = rp; E.intervals = intervals; E.radius = radius;
    E.an_bits = a1_bits; E.an_sgn = a1_sgn; E.dn_bits = 64;
    E.min_value = min_value; E.byte_size = byte_size;
    E.store_esize = store_esize;
    E.exact = exact; E.ecnt = 0;
    double check_radius = (intervals - 1) * rp;
    double interval2 = 2.0 * rp;
    types[0] = 0;
    ienc_store(&E, ld_int(x, in_esize, in_sgn));
    if (n < 2) return E.ecnt;
    types[1] = 0;
    int64_t v1 = ld_int(x + in_esize, in_esize, in_sgn);
    ienc_store(&E, v1);
    int64_t pred = wrap_bits(v1, a1_bits, a1_sgn);
    for (int64_t i = 2; i < n; i++) {
        int64_t cur = ld_int(x + i * in_esize, in_esize, in_sgn);
        int64_t d = cur - pred;
        int64_t pae = wrap_bits(d < 0 ? -d : d, a1_bits, a1_sgn);
        if ((double)pae < check_radius) {
            int state = (int)(((double)pae / rp + 1.0) / 2.0);
            if (cur >= pred) {
                types[i] = radius + state;
                pred = wrap_bits((int64_t)trunc((double)pred
                                                + state * interval2),
                                 a1_bits, a1_sgn);
            } else {
                types[i] = radius - state;
                pred = wrap_bits((int64_t)trunc((double)pred
                                                - state * interval2),
                                 a1_bits, a1_sgn);
            }
        } else {
            types[i] = 0;
            ienc_store(&E, cur);
            pred = wrap_bits(cur, a1_bits, a1_sgn);
        }
    }
    return E.ecnt;
}

/* Integer 1D decode (prev-value chain). */
void int1d_decode(const int32_t *types, int64_t n, double interval2,
                  int radius, int t_bits, int t_sgn, int64_t min_value,
                  int byte_size, int store_esize, const uint8_t *exact,
                  int64_t *out) {
    int64_t epos = 0;
    uint64_t mask = (store_esize >= 8) ? ~0ull
                    : ((~0ull) >> (64 - 8 * store_esize));
    int64_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        int t = types[i];
        if (t == 0) {
            uint64_t v = 0;
            for (int b = 0; b < byte_size; b++)
                v = (v << 8) | exact[epos++];
            v = (v + (uint64_t)min_value) & mask;
            prev = wrap_bits((int64_t)v, t_bits, t_sgn);
        } else {
            prev = wrap_bits(
                (int64_t)trunc((double)prev
                               + (t - radius) * interval2),
                t_bits, t_sgn);
        }
        out[i] = prev;
    }
}

/* MSST19 cache-table construction
 * (MultiLevelCacheTableWideInterval.c:47-186 state machine): for each
 * (exponent subrange, truncated mantissa) cell, assign the precision-
 * table interval whose (lo, hi) window contains the cell. */
void msst19_build_table(const double *pt, int64_t count, double precision,
                        int bits, int64_t base_index, int64_t nsub,
                        uint16_t *table) {
    int64_t size = 1ll << bits;
    double *lo = malloc(count * sizeof(double));
    double *hi = malloc(count * sizeof(double));
    for (int64_t i = 0; i < count; i++) {
        lo[i] = pt[i] / (1 + precision);
        hi[i] = pt[i] / (1 - precision);
    }
    int64_t index = 0;
    int flag = 0;
    for (int64_t i = 0; i < nsub; i++) {
        int64_t expo = i + base_index;
        for (int64_t j = 0; j < size; j++) {
            uint64_t vb = ((uint64_t)expo << 52)
                        + ((uint64_t)j << (52 - bits));
            uint64_t vt = ((uint64_t)expo << 52)
                        + ((uint64_t)(j + 1) << (52 - bits));
            double bot_s, top_s;
            memcpy(&bot_s, &vb, 8);
            memcpy(&top_s, &vt, 8);
            if (top_s < hi[index] && bot_s > lo[index]) {
                table[i * size + j] = (uint16_t)index;
                flag = 1;
            } else if (flag && index < count - 1) {
                index++;
                table[i * size + j] = (uint16_t)index;
            } else {
                table[i * size + j] = 0;
            }
        }
    }
    free(lo); free(hi);
}

/* --------------------------------------------------------------------
 * Blocked-regression preparation: per-block least-squares plane fit and
 * regression-vs-Lorenzo predictor selection, fused in one pass.
 * Numerical contract: core/regnd.py compute_reg_coeffs/select_predictor
 * (the oracle for sz_float.c:6563-6750 / sz_double.c:5944, and the 2D
 * variants with the a*(i-1) sampling quirk at sz_float.c:6023).
 * Blocks are independent -> OpenMP over the flat block index.
 * ------------------------------------------------------------------ */

#define GEN_PREP(SUF, FT, FABS)                                         \
void regnd_prep3d_##SUF(                                                \
    const FT *data, int64_t r1, int64_t r2, int64_t r3,                 \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    const int64_t *zo, const int64_t *zc, int64_t nbz,                  \
    FT noise, int use_mean, FT mean,                                    \
    FT *coeffs, uint8_t *use_reg) {                                     \
    int64_t nb = nbx * nby * nbz;                                       \
    _Pragma("omp parallel for schedule(static)")                        \
    for (int64_t b = 0; b < nb; b++) {                                  \
        int64_t i = b / (nby * nbz), rem = b % (nby * nbz);             \
        int64_t j = rem / nbz, k = rem % nbz;                           \
        int64_t cbx = xc[i], cby = yc[j], cbz = zc[k];                  \
        const FT *base = data + xo[i]*r2*r3 + yo[j]*r3 + zo[k];         \
        FT fx = 0, fy = 0, fz = 0, f = 0;                               \
        for (int64_t ii = 0; ii < cbx; ii++) {                          \
            FT sum_x = 0;                                               \
            for (int64_t jj = 0; jj < cby; jj++) {                      \
                FT sum_y = 0;                                           \
                for (int64_t kk = 0; kk < cbz; kk++) {                  \
                    FT cur = base[ii*r2*r3 + jj*r3 + kk];               \
                    sum_y += cur;                                       \
                    fz += cur * (FT)kk;                                 \
                }                                                       \
                fy += sum_y * (FT)jj;                                   \
                sum_x += sum_y;                                         \
            }                                                           \
            fx += sum_x * (FT)ii;                                       \
            f += sum_x;                                                 \
        }                                                               \
        FT coeff = (FT)(1.0 / (double)(cbx * cby * cbz));               \
        FT ca = ((FT)2*fx/(FT)(cbx-1) - f) * (FT)6 * coeff              \
                / (FT)(cbx+1);                                          \
        FT cb = ((FT)2*fy/(FT)(cby-1) - f) * (FT)6 * coeff              \
                / (FT)(cby+1);                                          \
        FT cc = ((FT)2*fz/(FT)(cbz-1) - f) * (FT)6 * coeff              \
                / (FT)(cbz+1);                                          \
        FT cd = f * coeff - ((FT)(cbx-1)*ca/(FT)2                       \
                             + (FT)(cby-1)*cb/(FT)2                     \
                             + (FT)(cbz-1)*cc/(FT)2);                   \
        coeffs[b*4+0] = ca; coeffs[b*4+1] = cb;                         \
        coeffs[b*4+2] = cc; coeffs[b*4+3] = cd;                         \
        int64_t bs = cbx < cby ? cbx : cby;                             \
        if (cbz < bs) bs = cbz;                                         \
        FT err_sz = 0, err_reg = 0;                                     \
        for (int64_t s = 1; s < bs; s++) {                              \
            int64_t bmi = bs - s;                                       \
            int64_t pis[4] = {s, s, s, s};                              \
            int64_t pjs[4] = {s, s, bmi, bmi};                          \
            int64_t pks[4] = {s, bmi, s, bmi};                          \
            for (int q = 0; q < 4; q++) {                               \
                int64_t pi = pis[q], pj = pjs[q], pk = pks[q];          \
                FT cur = base[pi*r2*r3 + pj*r3 + pk];                   \
                FT p = base[pi*r2*r3 + pj*r3 + pk-1]                    \
                     + base[pi*r2*r3 + (pj-1)*r3 + pk];                 \
                p = p + base[(pi-1)*r2*r3 + pj*r3 + pk];                \
                p = p - base[pi*r2*r3 + (pj-1)*r3 + pk-1];              \
                p = p - base[(pi-1)*r2*r3 + pj*r3 + pk-1];              \
                p = p - base[(pi-1)*r2*r3 + (pj-1)*r3 + pk];            \
                p = p + base[(pi-1)*r2*r3 + (pj-1)*r3 + pk-1];          \
                FT pr = ca*(FT)pi + cb*(FT)pj + cc*(FT)pk + cd;         \
                FT e = FABS(p - cur) + noise;                           \
                if (use_mean) {                                         \
                    FT m = FABS(mean - cur);                            \
                    if (m < e) e = m;                                   \
                }                                                       \
                err_sz += e;                                            \
                err_reg += FABS(pr - cur);                              \
            }                                                           \
        }                                                               \
        use_reg[b] = err_reg < err_sz;                                  \
    }                                                                   \
}                                                                       \
                                                                        \
void regnd_prep2d_##SUF(                                                \
    const FT *data, int64_t r1, int64_t r2,                             \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    FT noise, int use_mean, FT mean,                                    \
    FT *coeffs, uint8_t *use_reg) {                                     \
    int64_t nb = nbx * nby;                                             \
    _Pragma("omp parallel for schedule(static)")                        \
    for (int64_t b = 0; b < nb; b++) {                                  \
        int64_t i = b / nby, j = b % nby;                               \
        int64_t cbx = xc[i], cby = yc[j];                               \
        const FT *base = data + xo[i]*r2 + yo[j];                       \
        FT fx = 0, fy = 0, f = 0;                                       \
        for (int64_t ii = 0; ii < cbx; ii++) {                          \
            FT sum_x = 0;                                               \
            for (int64_t jj = 0; jj < cby; jj++) {                      \
                FT cur = base[ii*r2 + jj];                              \
                sum_x += cur;                                           \
                fy += cur * (FT)jj;                                     \
            }                                                           \
            fx += sum_x * (FT)ii;                                       \
            f += sum_x;                                                 \
        }                                                               \
        FT coeff = (FT)(1.0 / (double)(cbx * cby));                     \
        FT ca = ((FT)2*fx/(FT)(cbx-1) - f) * (FT)6 * coeff              \
                / (FT)(cbx+1);                                          \
        FT cb = ((FT)2*fy/(FT)(cby-1) - f) * (FT)6 * coeff              \
                / (FT)(cby+1);                                          \
        FT cc = f * coeff - ((FT)(cbx-1)*ca/(FT)2                       \
                             + (FT)(cby-1)*cb/(FT)2);                   \
        coeffs[b*3+0] = ca; coeffs[b*3+1] = cb; coeffs[b*3+2] = cc;     \
        int64_t bs = cbx < cby ? cbx : cby;                             \
        FT err_sz = 0, err_reg = 0;                                     \
        for (int64_t s = 1; s < bs; s++) {                              \
            int64_t bmi = bs - s;                                       \
            int64_t pis[2] = {s, s};                                    \
            int64_t pjs[2] = {s, bmi};                                  \
            FT pc0[2]; pc0[0] = (FT)s; pc0[1] = (FT)(s-1);              \
            for (int q = 0; q < 2; q++) {                               \
                int64_t pi = pis[q], pj = pjs[q];                       \
                FT cur = base[pi*r2 + pj];                              \
                FT p = base[pi*r2 + pj-1] + base[(pi-1)*r2 + pj]        \
                     - base[(pi-1)*r2 + pj-1];                          \
                FT pr = ca*pc0[q] + cb*(FT)pj + cc;                     \
                FT e = FABS(p - cur) + noise;                           \
                if (use_mean) {                                         \
                    FT m = FABS(mean - cur);                            \
                    if (m < e) e = m;                                   \
                }                                                       \
                err_sz += e;                                            \
                err_reg += FABS(pr - cur);                              \
            }                                                           \
        }                                                               \
        use_reg[b] = err_reg < err_sz;                                  \
    }                                                                   \
}

GEN_PREP(f32, float, fabsf)
GEN_PREP(f64, double, fabs)

/* --------------------------------------------------------------------
 * Multithreaded Huffman pack: per-chunk bit counts, then each chunk
 * packs at its absolute bit offset into a local buffer; interior bytes
 * memcpy'd, shared boundary bytes OR-merged serially.  Byte stream is
 * identical to the serial huff_encode.
 * ------------------------------------------------------------------ */

void huff_chunk_bits(const int32_t *syms, int64_t n,
                     const uint8_t *code_len, int nchunks, int64_t *bits) {
    int64_t per = (n + nchunks - 1) / nchunks;
    #pragma omp parallel for schedule(static)
    for (int c = 0; c < nchunks; c++) {
        int64_t lo = c * per, hi = lo + per;
        if (hi > n) hi = n;
        int64_t t = 0;
        for (int64_t i = lo; i < hi; i++) t += code_len[syms[i]];
        bits[c] = t;
    }
}

void huff_encode_chunks(const int32_t *syms, int64_t n,
                        const uint64_t *code_hi, const uint64_t *code_lo,
                        const uint8_t *code_len, int nchunks,
                        const int64_t *bits, uint8_t *out) {
    int64_t per = (n + nchunks - 1) / nchunks;
    int64_t *start = malloc(((int64_t)nchunks + 1) * sizeof(int64_t));
    uint8_t *firsts = calloc(nchunks, 1), *lasts = calloc(nchunks, 1);
    int64_t *sbs = calloc(nchunks, sizeof(int64_t));
    int64_t *Ls = calloc(nchunks, sizeof(int64_t));
    start[0] = 0;
    for (int c = 0; c < nchunks; c++) start[c + 1] = start[c] + bits[c];
    #pragma omp parallel for schedule(static)
    for (int c = 0; c < nchunks; c++) {
        int64_t lo = c * per, hi = lo + per;
        if (hi > n) hi = n;
        if (lo >= hi || bits[c] == 0) continue;
        int64_t sb = start[c] / 8;
        int sbit = (int)(start[c] % 8);
        int64_t L = (sbit + bits[c] + 7) / 8;
        uint8_t *loc = calloc(L + 16, 1);
        uint64_t acc = 0;
        int accbits = sbit;
        int64_t ob = 0;
        for (int64_t i = lo; i < hi; i++) {
            int32_t s = syms[i];
            int len = code_len[s];
            if (len <= 64) {
                ob = put_bits(code_hi[s], len, &acc, &accbits, loc, ob);
            } else {
                ob = put_bits(code_hi[s], 64, &acc, &accbits, loc, ob);
                ob = put_bits(code_lo[s], len - 64, &acc, &accbits, loc,
                              ob);
            }
        }
        if (accbits > 0) loc[ob++] = (uint8_t)(acc >> 56);
        sbs[c] = sb;
        Ls[c] = L;
        firsts[c] = loc[0];
        lasts[c] = loc[L - 1];
        if (L > 2) memcpy(out + sb + 1, loc + 1, (size_t)(L - 2));
        free(loc);
    }
    for (int c = 0; c < nchunks; c++) {
        if (!Ls[c]) continue;
        out[sbs[c]] |= firsts[c];
        if (Ls[c] > 1) out[sbs[c] + Ls[c] - 1] |= lasts[c];
    }
    free(start); free(firsts); free(lasts); free(sbs); free(Ls);
}

int64_t i32_hist_mt(const int32_t *x, int64_t n, int64_t *hist,
                    int64_t nbins) {
    int bad = 0;
    #pragma omp parallel
    {
        int64_t *loc = calloc(nbins, sizeof(int64_t));
        #pragma omp for schedule(static)
        for (int64_t i = 0; i < n; i++) {
            int32_t v = x[i];
            if (v < 0 || v >= nbins) bad = 1;
            else loc[v]++;
        }
        #pragma omp critical
        {
            for (int64_t b = 0; b < nbins; b++) hist[b] += loc[b];
        }
        free(loc);
    }
    return bad ? -1 : 0;
}

/* --------------------------------------------------------------------
 * Wavefront-parallel blocked-regression point kernels.
 *
 * Cross-block data flow in the serial kernels (above) is entirely via
 * reconstructed values on block boundary faces, always in the -x/-y/-z
 * direction.  Blocks on one anti-diagonal (bi+bj+bk == d) are therefore
 * independent: process diagonals in order, blocks within a diagonal
 * under OpenMP.  A zero-bordered padded reconstruction lattice replaces
 * the serial rolling strips (bit-identical: the strips are exactly the
 * fresh boundary entries of this lattice).  Unpredictable values are
 * staged at each block's cell offset and compacted to the serial order
 * afterwards.  Streams are byte-identical to the serial kernels.
 * ------------------------------------------------------------------ */


/* Thread-local scratch buffers for the wavefront kernels' big
 * per-call lattices.  A fresh multi-hundred-MB malloc/free per call
 * costs mmap + page faults every time (and on VMs that return freed
 * pages to the host, a catastrophic re-fault); growth-only reuse pays
 * the fault once per thread.  Requested outside OpenMP regions only,
 * so each *calling* thread owns its cache (thread-safe API holds). */
typedef struct { void *p; size_t cap; } tls_buf;
static _Thread_local tls_buf tl_bufs[3];

static void *wf_scratch(int slot, size_t bytes) {
    tls_buf *b = &tl_bufs[slot];
    if (b->cap < bytes) {
        free(b->p);
        b->p = malloc(bytes);
        b->cap = b->p ? bytes : 0;
    }
    return b->p;
}

static int64_t *regnd_diag_order3(int64_t nbx, int64_t nby, int64_t nbz,
                                  int64_t **dstart_out, int64_t *nd_out) {
    int64_t nb = nbx * nby * nbz;
    int64_t nd = nbx + nby + nbz - 2;
    int64_t *cnt = calloc(nd + 1, sizeof(int64_t));
    for (int64_t i = 0; i < nbx; i++)
        for (int64_t j = 0; j < nby; j++)
            for (int64_t k = 0; k < nbz; k++) cnt[i + j + k + 1]++;
    for (int64_t d = 0; d < nd; d++) cnt[d + 1] += cnt[d];
    int64_t *order = malloc(nb * sizeof(int64_t));
    int64_t *fill = malloc(nd * sizeof(int64_t));
    memcpy(fill, cnt, nd * sizeof(int64_t));
    for (int64_t i = 0; i < nbx; i++)
        for (int64_t j = 0; j < nby; j++)
            for (int64_t k = 0; k < nbz; k++)
                order[fill[i + j + k]++] = (i * nby + j) * nbz + k;
    free(fill);
    *dstart_out = cnt;
    *nd_out = nd;
    return order;
}

#define GEN_REGND_WF(SUF, FT, FABS)                                     \
int64_t regnd_encode3d_wf_##SUF(                                        \
    const FT *data, int64_t r1, int64_t r2, int64_t r3,                 \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    const int64_t *zo, const int64_t *zc, int64_t nbz,                  \
    const uint8_t *use_reg, const FT *qcoeffs,                          \
    FT rp, FT recip, int intervals, int use_mean, FT mean,              \
    int32_t *result_type, FT *unpred) {                                 \
    FT cap = (FT)intervals, cap_sz = (FT)(intervals - 2);               \
    int radius = intervals / 2;                                         \
    int64_t nb = nbx * nby * nbz, n = r1 * r2 * r3;                     \
    int64_t ps1 = (r2 + 1) * (r3 + 1), pr3 = r3 + 1;                    \
    FT *rec = wf_scratch(0, (size_t)(r1 + 1) * ps1 * sizeof(FT));      \
    memset(rec, 0, (size_t)(r1 + 1) * ps1 * sizeof(FT));                \
    FT *ubuf = wf_scratch(1, (size_t)n * sizeof(FT));                   \
    int64_t *tpos = malloc(nb * sizeof(int64_t));                       \
    int64_t *qpre = malloc(nb * sizeof(int64_t));                       \
    int64_t *ucb = calloc(nb, sizeof(int64_t));                         \
    {                                                                   \
        int64_t b = 0, qn = 0;                                          \
        for (int64_t i = 0; i < nbx; i++)                               \
        for (int64_t j = 0; j < nby; j++) {                             \
            int64_t tp = xo[i]*r2*r3 + yo[j]*xc[i]*r3;                  \
            for (int64_t k = 0; k < nbz; k++) {                         \
                tpos[b] = tp; qpre[b] = qn;                             \
                if (use_reg[b]) qn++;                                   \
                tp += xc[i] * yc[j] * zc[k];                            \
                b++;                                                    \
            }                                                           \
        }                                                               \
    }                                                                   \
    int64_t *dstart, ndiag;                                             \
    int64_t *order = regnd_diag_order3(nbx, nby, nbz, &dstart, &ndiag); \
    for (int64_t d = 0; d < ndiag; d++) {                               \
        int64_t lo = dstart[d], hi = dstart[d + 1];                     \
        _Pragma("omp parallel for schedule(dynamic)")                   \
        for (int64_t bi = lo; bi < hi; bi++) {                          \
            int64_t b = order[bi];                                      \
            int64_t i = b / (nby * nbz), rm = b % (nby * nbz);          \
            int64_t j = rm / nbz, k = rm % nbz;                         \
            int64_t cbx = xc[i], cby = yc[j], cbz = zc[k];              \
            int64_t ox = xo[i], oy = yo[j], oz = zo[k];                 \
            int64_t tp = tpos[b], uc = 0;                               \
            FT *ub = ubuf + tp;                                         \
            if (use_reg[b]) {                                           \
                const FT *lc = qcoeffs + qpre[b] * 4;                   \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++)                    \
                for (int64_t kk = 0; kk < cbz; kk++) {                  \
                    FT cur = data[(ox+ii)*r2*r3 + (oy+jj)*r3 + oz+kk];  \
                    FT pred = lc[0]*(FT)ii + lc[1]*(FT)jj               \
                            + lc[2]*(FT)kk + lc[3];                     \
                    FT rc;                                              \
                    int t = quant_point_##SUF(cur, pred, rp, recip,     \
                                              cap, radius, &rc);        \
                    if (t == 0) ub[uc++] = cur;                         \
                    result_type[tp + (ii*cby + jj)*cbz + kk] = t;       \
                    rec[(ox+ii+1)*ps1 + (oy+jj+1)*pr3 + oz+kk+1] = rc;  \
                }                                                       \
            } else {                                                    \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++)                    \
                for (int64_t kk = 0; kk < cbz; kk++) {                  \
                    FT cur = data[(ox+ii)*r2*r3 + (oy+jj)*r3 + oz+kk];  \
                    FT rc;                                              \
                    int t;                                              \
                    if (use_mean && FABS(cur - mean) <= rp) {           \
                        t = radius;                                     \
                        rc = mean;                                      \
                    } else {                                            \
                        int64_t sx = ox+ii+1, sy = oy+jj+1,             \
                                sz = oz+kk+1;                           \
                        const FT *rp0 = rec + sx*ps1 + sy*pr3 + sz;     \
                        FT p = rp0[-1] + rp0[-pr3];                     \
                        p = p + rp0[-ps1];                              \
                        p = p - rp0[-pr3-1];                            \
                        p = p - rp0[-ps1-1];                            \
                        p = p - rp0[-ps1-pr3];                          \
                        p = p + rp0[-ps1-pr3-1];                        \
                        t = quant_point_##SUF(cur, p, rp, recip,        \
                                              cap_sz, radius, &rc);     \
                        if (use_mean && t != 0 && t <= radius) t -= 1;  \
                    }                                                   \
                    if (t == 0) ub[uc++] = cur;                         \
                    result_type[tp + (ii*cby + jj)*cbz + kk] = t;       \
                    rec[(ox+ii+1)*ps1 + (oy+jj+1)*pr3 + oz+kk+1] = rc;  \
                }                                                       \
            }                                                           \
            ucb[b] = uc;                                                \
        }                                                               \
    }                                                                   \
    int64_t ucnt = 0;                                                   \
    for (int64_t b = 0; b < nb; b++) {                                  \
        if (ucb[b]) {                                                   \
            memmove(unpred + ucnt, ubuf + tpos[b],                      \
                    (size_t)ucb[b] * sizeof(FT));                       \
            ucnt += ucb[b];                                             \
        }                                                               \
    }                                                                   \
    free(tpos); free(qpre); free(ucb);                                  \
    free(order); free(dstart);                                          \
    return ucnt;                                                        \
}                                                                       \
                                                                        \
void regnd_decode3d_wf_##SUF(                                           \
    const int32_t *types, int64_t r1, int64_t r2, int64_t r3,           \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    const int64_t *zo, const int64_t *zc, int64_t nbz,                  \
    const uint8_t *indicator, const FT *qcoeffs, const FT *unpred,      \
    FT rp, int intervals, int use_mean, FT mean, FT *out) {             \
    int radius = intervals / 2;                                         \
    int64_t nb = nbx * nby * nbz;                                       \
    int64_t *tpos = malloc(nb * sizeof(int64_t));                       \
    int64_t *qpre = malloc(nb * sizeof(int64_t));                       \
    int64_t *uoff = malloc((nb + 1) * sizeof(int64_t));                 \
    {                                                                   \
        int64_t b = 0, qn = 0;                                          \
        for (int64_t i = 0; i < nbx; i++)                               \
        for (int64_t j = 0; j < nby; j++) {                             \
            int64_t tp = xo[i]*r2*r3 + yo[j]*xc[i]*r3;                  \
            for (int64_t k = 0; k < nbz; k++) {                         \
                tpos[b] = tp; qpre[b] = qn;                             \
                if (!indicator[b]) qn++;                                \
                tp += xc[i] * yc[j] * zc[k];                            \
                b++;                                                    \
            }                                                           \
        }                                                               \
    }                                                                   \
    _Pragma("omp parallel for schedule(static)")                        \
    for (int64_t b = 0; b < nb; b++) {                                  \
        int64_t i = b / (nby * nbz), rm = b % (nby * nbz);              \
        int64_t j = rm / nbz, k = rm % nbz;                             \
        int64_t vol = xc[i] * yc[j] * zc[k];                            \
        int64_t z = 0;                                                  \
        const int32_t *ty = types + tpos[b];                            \
        for (int64_t c = 0; c < vol; c++) z += (ty[c] == 0);            \
        uoff[b + 1] = z;                                                \
    }                                                                   \
    uoff[0] = 0;                                                        \
    for (int64_t b = 0; b < nb; b++) uoff[b + 1] += uoff[b];            \
    int64_t *dstart, ndiag;                                             \
    int64_t *order = regnd_diag_order3(nbx, nby, nbz, &dstart, &ndiag); \
    for (int64_t d = 0; d < ndiag; d++) {                               \
        int64_t lo = dstart[d], hi = dstart[d + 1];                     \
        _Pragma("omp parallel for schedule(dynamic)")                   \
        for (int64_t bi = lo; bi < hi; bi++) {                          \
            int64_t b = order[bi];                                      \
            int64_t i = b / (nby * nbz), rm = b % (nby * nbz);          \
            int64_t j = rm / nbz, k = rm % nbz;                         \
            int64_t cbx = xc[i], cby = yc[j], cbz = zc[k];              \
            int64_t ox = xo[i], oy = yo[j], oz = zo[k];                 \
            int64_t tp = tpos[b], upos = uoff[b];                       \
            if (indicator[b]) {                                         \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++)                    \
                for (int64_t kk = 0; kk < cbz; kk++) {                  \
                    int t = types[tp + (ii*cby + jj)*cbz + kk];         \
                    int64_t x = ox+ii, y = oy+jj, z = oz+kk;            \
                    int64_t c = x*r2*r3 + y*r3 + z;                     \
                    if (use_mean && t == radius) {                      \
                        out[c] = mean;                                  \
                    } else if (t == 0) {                                \
                        out[c] = unpred[upos++];                        \
                    } else {                                            \
                        FT d110 = z ? out[c-1] : (FT)0;                 \
                        FT d101 = y ? out[c-r3] : (FT)0;                \
                        FT d011 = x ? out[c-r2*r3] : (FT)0;             \
                        FT d100 = (y && z) ? out[c-r3-1] : (FT)0;       \
                        FT d010 = (x && z) ? out[c-r2*r3-1] : (FT)0;    \
                        FT d001 = (x && y) ? out[c-r2*r3-r3] : (FT)0;   \
                        FT d000 = (x && y && z)                         \
                                  ? out[c-r2*r3-r3-1] : (FT)0;          \
                        if (use_mean && t < radius) t += 1;             \
                        FT p = d110 + d101;                             \
                        p = p + d011;                                   \
                        p = p - d100;                                   \
                        p = p - d010;                                   \
                        p = p - d001;                                   \
                        p = p + d000;                                   \
                        out[c] = p + (FT)(2 * (t - radius)) * rp;       \
                    }                                                   \
                }                                                       \
            } else {                                                    \
                const FT *lc = qcoeffs + qpre[b] * 4;                   \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++)                    \
                for (int64_t kk = 0; kk < cbz; kk++) {                  \
                    int t = types[tp + (ii*cby + jj)*cbz + kk];         \
                    int64_t c = (ox+ii)*r2*r3 + (oy+jj)*r3 + oz+kk;     \
                    if (t != 0) {                                       \
                        FT pred = lc[0]*(FT)ii + lc[1]*(FT)jj           \
                                + lc[2]*(FT)kk + lc[3];                 \
                        out[c] = pred + (FT)(2 * (t - radius)) * rp;    \
                    } else {                                            \
                        out[c] = unpred[upos++];                        \
                    }                                                   \
                }                                                       \
            }                                                           \
        }                                                               \
    }                                                                   \
    free(tpos); free(qpre); free(uoff); free(order); free(dstart);      \
}

GEN_REGND_WF(f32, float, fabsf)
GEN_REGND_WF(f64, double, fabs)
#undef GEN_REGND_WF

/* 2D wavefront variants (use_mean is forced off by the 2D codec). */

#define GEN_REGND_WF2(SUF, FT, FABS)                                    \
int64_t regnd_encode2d_wf_##SUF(                                        \
    const FT *data, int64_t r1, int64_t r2,                             \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    const uint8_t *use_reg, const FT *qcoeffs,                          \
    FT rp, FT recip, int intervals,                                     \
    int32_t *result_type, FT *unpred) {                                 \
    FT cap = (FT)intervals, cap_sz = (FT)(intervals - 2);               \
    int radius = intervals / 2;                                         \
    int64_t nb = nbx * nby, n = r1 * r2, pr2 = r2 + 1;                  \
    FT *rec = wf_scratch(0, (size_t)(r1 + 1) * pr2 * sizeof(FT));      \
    memset(rec, 0, (size_t)(r1 + 1) * pr2 * sizeof(FT));                \
    FT *ubuf = wf_scratch(1, (size_t)n * sizeof(FT));                   \
    int64_t *tpos = malloc(nb * sizeof(int64_t));                       \
    int64_t *qpre = malloc(nb * sizeof(int64_t));                       \
    int64_t *ucb = calloc(nb, sizeof(int64_t));                         \
    {                                                                   \
        int64_t b = 0, qn = 0;                                          \
        for (int64_t i = 0; i < nbx; i++) {                             \
            int64_t tp = xo[i] * r2;                                    \
            for (int64_t j = 0; j < nby; j++) {                         \
                tpos[b] = tp; qpre[b] = qn;                             \
                if (use_reg[b]) qn++;                                   \
                tp += xc[i] * yc[j];                                    \
                b++;                                                    \
            }                                                           \
        }                                                               \
    }                                                                   \
    for (int64_t d = 0; d <= nbx + nby - 2; d++) {                      \
        int64_t ilo = d - (nby - 1) > 0 ? d - (nby - 1) : 0;            \
        int64_t ihi = d < nbx - 1 ? d : nbx - 1;                        \
        _Pragma("omp parallel for schedule(dynamic)")                   \
        for (int64_t i = ilo; i <= ihi; i++) {                          \
            int64_t j = d - i;                                          \
            int64_t b = i * nby + j;                                    \
            int64_t cbx = xc[i], cby = yc[j], ox = xo[i], oy = yo[j];   \
            int64_t tp = tpos[b], uc = 0;                               \
            FT *ub = ubuf + tp;                                         \
            if (use_reg[b]) {                                           \
                const FT *lc = qcoeffs + qpre[b] * 3;                   \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++) {                  \
                    FT cur = data[(ox+ii)*r2 + oy+jj];                  \
                    FT pred = lc[0]*(FT)ii + lc[1]*(FT)jj + lc[2];      \
                    FT rc;                                              \
                    int t = quant_point_##SUF(cur, pred, rp, recip,     \
                                              cap, radius, &rc);        \
                    if (t == 0) ub[uc++] = cur;                         \
                    result_type[tp + ii*cby + jj] = t;                  \
                    rec[(ox+ii+1)*pr2 + oy+jj+1] = rc;                  \
                }                                                       \
            } else {                                                    \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++) {                  \
                    FT cur = data[(ox+ii)*r2 + oy+jj];                  \
                    const FT *rp0 = rec + (ox+ii+1)*pr2 + oy+jj+1;      \
                    FT p = rp0[-1] + rp0[-pr2] - rp0[-pr2-1];           \
                    FT rc;                                              \
                    int t = quant_point_##SUF(cur, p, rp, recip,        \
                                              cap_sz, radius, &rc);     \
                    if (t == 0) ub[uc++] = cur;                         \
                    result_type[tp + ii*cby + jj] = t;                  \
                    rec[(ox+ii+1)*pr2 + oy+jj+1] = rc;                  \
                }                                                       \
            }                                                           \
            ucb[b] = uc;                                                \
        }                                                               \
    }                                                                   \
    int64_t ucnt = 0;                                                   \
    for (int64_t b = 0; b < nb; b++) {                                  \
        if (ucb[b]) {                                                   \
            memmove(unpred + ucnt, ubuf + tpos[b],                      \
                    (size_t)ucb[b] * sizeof(FT));                       \
            ucnt += ucb[b];                                             \
        }                                                               \
    }                                                                   \
    free(tpos); free(qpre); free(ucb);                                  \
    return ucnt;                                                        \
}                                                                       \
                                                                        \
void regnd_decode2d_wf_##SUF(                                           \
    const int32_t *types, int64_t r1, int64_t r2,                       \
    const int64_t *xo, const int64_t *xc, int64_t nbx,                  \
    const int64_t *yo, const int64_t *yc, int64_t nby,                  \
    const uint8_t *indicator, const FT *qcoeffs, const FT *unpred,      \
    FT rp, int intervals, int use_mean, FT mean, FT *out) {             \
    int radius = intervals / 2;                                         \
    int64_t nb = nbx * nby;                                             \
    int64_t *tpos = malloc(nb * sizeof(int64_t));                       \
    int64_t *qpre = malloc(nb * sizeof(int64_t));                       \
    int64_t *uoff = malloc((nb + 1) * sizeof(int64_t));                 \
    {                                                                   \
        int64_t b = 0, qn = 0;                                          \
        for (int64_t i = 0; i < nbx; i++) {                             \
            int64_t tp = xo[i] * r2;                                    \
            for (int64_t j = 0; j < nby; j++) {                         \
                tpos[b] = tp; qpre[b] = qn;                             \
                if (!indicator[b]) qn++;                                \
                tp += xc[i] * yc[j];                                    \
                b++;                                                    \
            }                                                           \
        }                                                               \
    }                                                                   \
    _Pragma("omp parallel for schedule(static)")                        \
    for (int64_t b = 0; b < nb; b++) {                                  \
        int64_t i = b / nby, j = b % nby;                               \
        int64_t vol = xc[i] * yc[j], z = 0;                             \
        const int32_t *ty = types + tpos[b];                            \
        for (int64_t c = 0; c < vol; c++) z += (ty[c] == 0);            \
        uoff[b + 1] = z;                                                \
    }                                                                   \
    uoff[0] = 0;                                                        \
    for (int64_t b = 0; b < nb; b++) uoff[b + 1] += uoff[b];            \
    for (int64_t d = 0; d <= nbx + nby - 2; d++) {                      \
        int64_t ilo = d - (nby - 1) > 0 ? d - (nby - 1) : 0;            \
        int64_t ihi = d < nbx - 1 ? d : nbx - 1;                        \
        _Pragma("omp parallel for schedule(dynamic)")                   \
        for (int64_t i = ilo; i <= ihi; i++) {                          \
            int64_t j = d - i;                                          \
            int64_t b = i * nby + j;                                    \
            int64_t cbx = xc[i], cby = yc[j], ox = xo[i], oy = yo[j];   \
            int64_t tp = tpos[b], upos = uoff[b];                       \
            if (indicator[b]) {                                         \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++) {                  \
                    int t = types[tp + ii*cby + jj];                    \
                    int64_t x = ox+ii, y = oy+jj;                       \
                    int64_t c = x*r2 + y;                               \
                    if (use_mean && t == radius) {                      \
                        out[c] = mean;                                  \
                    } else if (t == 0) {                                \
                        out[c] = unpred[upos++];                        \
                    } else {                                            \
                        FT d10 = y ? out[c-1] : (FT)0;                  \
                        FT d01 = x ? out[c-r2] : (FT)0;                 \
                        FT d00 = (x && y) ? out[c-r2-1] : (FT)0;        \
                        if (use_mean && t < radius) t += 1;             \
                        FT p = d10 + d01 - d00;                         \
                        out[c] = p + (FT)(2 * (t - radius)) * rp;       \
                    }                                                   \
                }                                                       \
            } else {                                                    \
                const FT *lc = qcoeffs + qpre[b] * 3;                   \
                for (int64_t ii = 0; ii < cbx; ii++)                    \
                for (int64_t jj = 0; jj < cby; jj++) {                  \
                    int t = types[tp + ii*cby + jj];                    \
                    int64_t c = (ox+ii)*r2 + oy+jj;                     \
                    if (t != 0) {                                       \
                        FT pred = lc[0]*(FT)ii + lc[1]*(FT)jj + lc[2];  \
                        out[c] = pred + (FT)(2 * (t - radius)) * rp;    \
                    } else {                                            \
                        out[c] = unpred[upos++];                        \
                    }                                                   \
                }                                                       \
            }                                                           \
        }                                                               \
    }                                                                   \
    free(tpos); free(qpre); free(uoff);                                 \
}

GEN_REGND_WF2(f32, float, fabsf)
GEN_REGND_WF2(f64, double, fabs)
#undef GEN_REGND_WF2

/* --------------------------------------------------------------------
 * Byte-FSM table build for Huffman decode: for every internal tree
 * state and input byte, walk the 8 bits recording emitted symbols and
 * the landing state.  States are independent -> OpenMP.
 * ------------------------------------------------------------------ */

void huff_fsm_build(const int32_t *L, const int32_t *R, const int32_t *C,
                    const uint8_t *T, int64_t n_nodes,
                    int32_t *next_state, int8_t *emit_cnt,
                    int32_t *emit_syms) {
    #pragma omp parallel for schedule(dynamic, 64)
    for (int64_t s = 0; s < n_nodes; s++) {
        if (T[s]) continue;
        for (int byte = 0; byte < 256; byte++) {
            int32_t st = (int32_t)s;
            int cnt = 0;
            for (int bit = 7; bit >= 0; bit--) {
                st = ((byte >> bit) & 1) ? R[st] : L[st];
                if (T[st]) {
                    if (cnt < 8) emit_syms[(s * 256 + byte) * 8 + cnt]
                        = C[st];
                    cnt++;
                    st = 0;
                }
            }
            next_state[s * 256 + byte] = st;
            emit_cnt[s * 256 + byte] = (int8_t)cnt;
        }
    }
}

/* MSB-first fixed-width (w < 8) bit pack of byte values
 * (convertIntArray2ByteArray_fast_dynamic, TypeManager.c:377). */
void pack_w_bits(const uint8_t *vals, int64_t n, int w, uint8_t *out) {
    uint64_t acc = 0;
    int accbits = 0;
    int64_t ob = 0;
    for (int64_t i = 0; i < n; i++) {
        acc = (acc << w) | vals[i];
        accbits += w;
        while (accbits >= 8) {
            out[ob++] = (uint8_t)(acc >> (accbits - 8));
            accbits -= 8;
        }
    }
    if (accbits) out[ob++] = (uint8_t)(acc << (8 - accbits));
}

/* MSB-first fixed-width (w <= 24) bit pack of int32 symbol values.
 * Feeds the device decode path: the packed stream uploads ~w/16 of the
 * raw uint16 types and unpacks on device with two word gathers per
 * symbol (sz_tpu/tpu/engine._delattice_packed_fn).  OpenMP chunks are
 * 8-symbol aligned so every chunk starts on a byte boundary. */
void pack_wide_bits(const int32_t *vals, int64_t n, int w, uint8_t *out) {
    const int64_t chunk = 1 << 18; /* multiple of 8 symbols */
    const int64_t nch = (n + chunk - 1) / chunk;
    #pragma omp parallel for schedule(static)
    for (int64_t c = 0; c < nch; c++) {
        int64_t a = c * chunk;
        int64_t b = a + chunk < n ? a + chunk : n;
        uint64_t acc = 0;
        int accbits = 0;
        int64_t ob = a * w / 8;
        for (int64_t i = a; i < b; i++) {
            acc = (acc << w) | (uint32_t)vals[i];
            accbits += w;
            while (accbits >= 8) {
                out[ob++] = (uint8_t)(acc >> (accbits - 8));
                accbits -= 8;
            }
        }
        if (accbits) out[ob] = (uint8_t)(acc << (8 - accbits));
    }
}

/* ------------------------------------------------------------------ */
/* Blocked-wavefront classic MDQ kernels (SZ1.4 cell Lorenzo,          */
/* sz_float.c:353-1478 semantics).  The serial cell recurrence is      */
/* re-scheduled over bs^3 tiles whose block anti-diagonals run in      */
/* parallel: a tile only reads reconstructions at -1 offsets in each   */
/* axis, i.e. from tiles earlier on the block-diagonal order.  Streams */
/* are bit-identical to classicnd_encode/_decode because the escape    */
/* reconstruction is state-free (the xenc lead-byte chain only shapes  */
/* stream bytes, not recon values), so the lead/mid/resi streams are   */
/* re-assembled in raster order after the sweep.                       */
/* ------------------------------------------------------------------ */

static inline float xtrunc_f32(float value, float median, int raw,
                               uint32_t mask) {
    float norm = raw ? value : value - median;
    uint32_t ival;
    memcpy(&ival, &norm, 4);
    uint32_t rbits = ival & mask;
    float recon;
    memcpy(&recon, &rbits, 4);
    if (!raw) recon = recon + median;
    return recon;
}

static inline double xtrunc_f64(double value, double median, int raw,
                                uint64_t mask) {
    double norm = raw ? value : value - median;
    uint64_t ival;
    memcpy(&ival, &norm, 8);
    uint64_t rbits = ival & mask;
    double recon;
    memcpy(&recon, &rbits, 8);
    if (!raw) recon = recon + median;
    return recon;
}


/* Per-(row, z-tile) escape-count prefix tables shared by the wavefront
 * decoders: zpre[row][zb] = zeros in [row*r3, row*r3 + zb*bs), with
 * zpre[row][nbz] = the row total; rowstart = exclusive scan of row
 * totals.  Caller frees both. */
static void wf_zero_ordinals(const int32_t *types, int64_t nrows,
                             int64_t r3, int64_t nbz, int bs,
                             int64_t **zpre_out, int64_t **rowstart_out) {
    int64_t *zpre = malloc(nrows * (nbz + 1) * sizeof(int64_t));
    #pragma omp parallel for schedule(static)
    for (int64_t row = 0; row < nrows; row++) {
        const int32_t *ty = types + row * r3;
        int64_t *zp = zpre + row * (nbz + 1);
        int64_t cnt = 0, zb = 0;
        for (int64_t c = 0; c < r3; c++) {
            if (c == zb * bs) zp[zb++] = cnt;
            if (ty[c] == 0) cnt++;
        }
        zp[nbz] = cnt;
    }
    int64_t *rowstart = malloc((nrows + 1) * sizeof(int64_t));
    rowstart[0] = 0;
    for (int64_t row = 0; row < nrows; row++)
        rowstart[row + 1] = rowstart[row] + zpre[row * (nbz + 1) + nbz];
    *zpre_out = zpre;
    *rowstart_out = rowstart;
}

#define GEN_CLASSIC_WF(SUF, FT, ESIZE, MASKT, XADD, XNEXT)              \
static inline FT cnd_quantwf_##SUF(int32_t *types, int64_t idx, FT cur, \
                                   FT pred, double rp64, double recip64,\
                                   FT rp, FT recip, int intervals,      \
                                   int radius, int dbl, int sb,         \
                                   FT median, MASKT mask) {             \
    FT diff = cur - pred;                                               \
    if (sb) {                                                           \
        /* subblock quantizer: double division, no epsilon recheck      \
         * (sz_float.c:3862-3871) */                                    \
        double itv = fabs((double)diff) / rp64 + 1.0;                   \
        if (itv < (double)intervals) {                                  \
            if (diff < 0) itv = -itv;                                   \
            int t = (int)(itv / 2.0) + radius;                          \
            FT rec = (FT)((double)pred                                  \
                          + (double)(2 * (t - radius)) * rp64);         \
            types[idx] = t;                                             \
            return rec;                                                 \
        }                                                               \
        types[idx] = 0;                                                 \
        return xtrunc_##SUF(cur, median, 0, mask);                      \
    }                                                                   \
    if (dbl) {                                                          \
        double itv = fabs((double)diff) * recip64 + 1.0;                \
        if (itv < (double)intervals) {                                  \
            if (diff < 0) itv = -itv;                                   \
            int t = (int)(itv / 2.0) + radius;                          \
            FT rec = (FT)((double)pred                                  \
                          + (double)(2 * (t - radius)) * rp64);         \
            if (fabs((double)(FT)(cur - rec)) > rp64) {                 \
                types[idx] = 0;                                         \
                return xtrunc_##SUF(cur, median, 0, mask);              \
            }                                                           \
            types[idx] = t;                                             \
            return rec;                                                 \
        }                                                               \
    } else {                                                            \
        FT itv = (FT)(fabs((double)diff) * (double)recip + 1.0);        \
        if (itv < (FT)intervals) {                                      \
            if (diff < 0) itv = -itv;                                   \
            int t = (int)(itv / (FT)2) + radius;                        \
            FT rec = pred + (FT)(2 * (t - radius)) * rp;                \
            if (fabs((double)(FT)(cur - rec)) > (double)rp) {           \
                types[idx] = 0;                                         \
                return xtrunc_##SUF(cur, median, 0, mask);              \
            }                                                           \
            types[idx] = t;                                             \
            return rec;                                                 \
        }                                                               \
    }                                                                   \
    types[idx] = 0;                                                     \
    return xtrunc_##SUF(cur, median, 0, mask);                          \
}                                                                       \
                                                                        \
int64_t classicnd_encode_wf_##SUF(                                      \
    const FT *x, int64_t q1, int64_t r1, int64_t r2, int64_t r3,        \
    double rp64, double recip64, FT rp, FT recip, int intervals,        \
    int radius, int dbl, int sb, int req_length, FT median, int bs,     \
    int32_t *types, uint8_t *lead, uint8_t *mid, int64_t *nmid,         \
    uint8_t *resi) {                                                    \
    int64_t r23 = r2 * r3, vol = r1 * r23, ntot = q1 * vol;             \
    MASKT mask = (MASKT)xenc_mask(ESIZE, req_length);                   \
    FT *rec = wf_scratch(0, (size_t)vol * sizeof(FT));                  \
    int64_t nbx = (r1 + bs - 1) / bs, nby = (r2 + bs - 1) / bs,         \
            nbz = (r3 + bs - 1) / bs;                                   \
    int64_t *dstart, ndiag;                                             \
    int64_t *order = regnd_diag_order3(nbx, nby, nbz, &dstart, &ndiag); \
    for (int64_t l = 0; l < q1; l++) {                                  \
        const FT *xl = x + l * vol;                                     \
        int32_t *tl = types + l * vol;                                  \
        for (int64_t d = 0; d < ndiag; d++) {                           \
            int64_t lo = dstart[d], hi = dstart[d + 1];                 \
            _Pragma("omp parallel for schedule(dynamic)")               \
            for (int64_t bi = lo; bi < hi; bi++) {                      \
                int64_t b = order[bi];                                  \
                int64_t i = b / (nby * nbz), rm = b % (nby * nbz);      \
                int64_t j = rm / nbz, kb = rm % nbz;                    \
                int64_t ox = i * bs, oy = j * bs, oz = kb * bs;         \
                int64_t ex = ox + bs < r1 ? ox + bs : r1;               \
                int64_t ey = oy + bs < r2 ? oy + bs : r2;               \
                int64_t ez = oz + bs < r3 ? oz + bs : r3;               \
                if (ox > 0 && oy > 0 && oz > 0) {                       \
                    /* interior tile: pure 7-point Lorenzo */           \
                    for (int64_t a = ox; a < ex; a++)                   \
                    for (int64_t bb = oy; bb < ey; bb++) {              \
                        int64_t idx = a * r23 + bb * r3 + oz;           \
                        for (int64_t c = oz; c < ez; c++, idx++) {      \
                            FT p = rec[idx-1] + rec[idx-r3];            \
                            p = p + rec[idx-r23];                       \
                            p = p - rec[idx-r3-1];                      \
                            p = p - rec[idx-r23-r3];                    \
                            p = p - rec[idx-r23-1];                     \
                            p = p + rec[idx-r23-r3-1];                  \
                            rec[idx] = cnd_quantwf_##SUF(               \
                                tl, idx, xl[idx], p, rp64, recip64,     \
                                rp, recip, intervals, radius, dbl, sb,  \
                                median, mask);                          \
                        }                                               \
                    }                                                   \
                } else if (oy > 0 && oz > 0) {                          \
                    /* ox == 0 tile: first plane rows are 2D Lorenzo */ \
                    for (int64_t a = ox; a < ex; a++)                   \
                    for (int64_t bb = oy; bb < ey; bb++) {              \
                        int64_t idx = a * r23 + bb * r3 + oz;           \
                        if (a == 0) {                                   \
                            for (int64_t c = oz; c < ez; c++, idx++) {  \
                                FT p = rec[idx-1] + rec[idx-r3]         \
                                       - rec[idx-r3-1];                 \
                                rec[idx] = cnd_quantwf_##SUF(           \
                                    tl, idx, xl[idx], p, rp64, recip64, \
                                    rp, recip, intervals, radius, dbl,  \
                                    sb, median, mask);                      \
                            }                                           \
                        } else {                                        \
                            for (int64_t c = oz; c < ez; c++, idx++) {  \
                                FT p = rec[idx-1] + rec[idx-r3];        \
                                p = p + rec[idx-r23];                   \
                                p = p - rec[idx-r3-1];                  \
                                p = p - rec[idx-r23-r3];                \
                                p = p - rec[idx-r23-1];                 \
                                p = p + rec[idx-r23-r3-1];              \
                                rec[idx] = cnd_quantwf_##SUF(           \
                                    tl, idx, xl[idx], p, rp64, recip64, \
                                    rp, recip, intervals, radius, dbl,  \
                                    sb, median, mask);                      \
                            }                                           \
                        }                                               \
                    }                                                   \
                } else {                                                \
                    /* boundary tile: per-cell case analysis */         \
                    for (int64_t a = ox; a < ex; a++)                   \
                    for (int64_t bb = oy; bb < ey; bb++)                \
                    for (int64_t c = oz; c < ez; c++) {                 \
                        int64_t idx = a * r23 + bb * r3 + c;            \
                        FT cur = xl[idx];                               \
                        FT p;                                           \
                        if (a > 0 && bb > 0 && c > 0) {                 \
                            p = rec[idx-1] + rec[idx-r3];               \
                            p = p + rec[idx-r23];                       \
                            p = p - rec[idx-r3-1];                      \
                            p = p - rec[idx-r23-r3];                    \
                            p = p - rec[idx-r23-1];                     \
                            p = p + rec[idx-r23-r3-1];                  \
                        } else if (a == 0) {                            \
                            if (bb == 0) {                              \
                                if (c == 0) {                           \
                                    tl[idx] = 0;                        \
                                    rec[idx] = xtrunc_##SUF(            \
                                        cur, median, 0, mask);          \
                                    continue;                           \
                                } else if (c == 1) {                    \
                                    p = rec[idx-1];                     \
                                } else {                                \
                                    p = (FT)2 * rec[idx-1]              \
                                        - rec[idx-2];                   \
                                }                                       \
                            } else if (c == 0) {                        \
                                p = rec[idx - r3];                      \
                            } else {                                    \
                                p = rec[idx-1] + rec[idx-r3]            \
                                    - rec[idx-r3-1];                    \
                            }                                           \
                        } else if (bb == 0) {                           \
                            if (c == 0) p = rec[idx - r23];             \
                            else p = rec[idx-1] + rec[idx-r23]          \
                                     - rec[idx-r23-1];                  \
                        } else {                                        \
                            p = rec[idx-r3] + rec[idx-r23]              \
                                - rec[idx-r23-r3];                      \
                        }                                               \
                        rec[idx] = cnd_quantwf_##SUF(                   \
                            tl, idx, cur, p, rp64, recip64, rp, recip,  \
                            intervals, radius, dbl, sb, median, mask);      \
                    }                                                   \
                }                                                       \
            }                                                           \
        }                                                               \
    }                                                                   \
    free(order); free(dstart);                                          \
    /* escape streams in raster order (state-free recon above makes    \
     * this equivalent to emitting inline) */                           \
    xenc E;                                                             \
    E.esize = ESIZE;                                                    \
    E.req_bytes = req_length / 8; E.resi_len = req_length % 8;          \
    if (E.req_bytes > ESIZE) E.req_bytes = ESIZE;                       \
    memset(E.prev, 0, 8);                                               \
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;                \
    E.resi = resi; E.nresi = 0;                                         \
    for (int64_t idx = 0; idx < ntot; idx++)                            \
        if (types[idx] == 0) XADD(&E, x[idx], median, 0, mask);         \
    *nmid = E.nmid;                                                     \
    return E.nlead;                                                     \
}                                                                       \
                                                                        \
void classicnd_decode_wf_##SUF(                                         \
    const int32_t *types, int64_t q1, int64_t r1, int64_t r2,           \
    int64_t r3, double rp64, FT rp, int radius, int dbl,                \
    int req_length, FT median, const uint8_t *lead,                     \
    const uint8_t *mid, const uint8_t *resi, int64_t nesc, int bs,      \
    FT *out) {                                                          \
    int64_t r23 = r2 * r3, vol = r1 * r23;                              \
    /* 1. serial escape-value decode (state chain is in the stream) */  \
    xdec D;                                                             \
    D.esize = ESIZE;                                                    \
    D.req_bytes = req_length / 8; D.resi_len = req_length % 8;          \
    if (D.req_bytes > ESIZE) D.req_bytes = ESIZE;                       \
    memset(D.prev, 0, 8);                                               \
    D.lead = lead; D.k = 0; D.mid = mid; D.midp = 0;                    \
    D.resi = resi; D.bitp = 0;                                          \
    FT *vals = wf_scratch(2, (size_t)(nesc > 0 ? nesc : 1)             \
                          * sizeof(FT));                                \
    for (int64_t m = 0; m < nesc; m++) vals[m] = XNEXT(&D, median, 0);  \
    /* 2. escape-ordinal tables at (row, z-tile) granularity */         \
    int64_t nbx = (r1 + bs - 1) / bs, nby = (r2 + bs - 1) / bs,         \
            nbz = (r3 + bs - 1) / bs;                                   \
    int64_t nrows = q1 * r1 * r2;                                       \
    int64_t *zpre, *rowstart;                                           \
    wf_zero_ordinals(types, nrows, r3, nbz, bs, &zpre, &rowstart);      \
    /* 3. wavefront replay */                                           \
    int64_t *dstart, ndiag;                                             \
    int64_t *order = regnd_diag_order3(nbx, nby, nbz, &dstart, &ndiag); \
    for (int64_t l = 0; l < q1; l++) {                                  \
        const int32_t *tl = types + l * vol;                            \
        FT *o = out + l * vol;                                          \
        for (int64_t d = 0; d < ndiag; d++) {                           \
            int64_t lo = dstart[d], hi = dstart[d + 1];                 \
            _Pragma("omp parallel for schedule(dynamic)")               \
            for (int64_t bi = lo; bi < hi; bi++) {                      \
                int64_t b = order[bi];                                  \
                int64_t i = b / (nby * nbz), rm = b % (nby * nbz);      \
                int64_t j = rm / nbz, kb = rm % nbz;                    \
                int64_t ox = i * bs, oy = j * bs, oz = kb * bs;         \
                int64_t ex = ox + bs < r1 ? ox + bs : r1;               \
                int64_t ey = oy + bs < r2 ? oy + bs : r2;               \
                int64_t ez = oz + bs < r3 ? oz + bs : r3;               \
                for (int64_t a = ox; a < ex; a++)                       \
                for (int64_t bb = oy; bb < ey; bb++) {                  \
                    int64_t row = (l * r1 + a) * r2 + bb;               \
                    int64_t ord = rowstart[row]                         \
                                  + zpre[row * (nbz + 1) + kb];         \
                    int64_t idx = a * r23 + bb * r3 + oz;               \
                    for (int64_t c = oz; c < ez; c++, idx++) {          \
                        int t = tl[idx];                                \
                        if (t == 0) { o[idx] = vals[ord++]; continue; } \
                        FT p;                                           \
                        if (a > 0 && bb > 0 && c > 0) {                 \
                            p = o[idx-1] + o[idx-r3];                   \
                            p = p + o[idx-r23];                         \
                            p = p - o[idx-r3-1];                        \
                            p = p - o[idx-r23-r3];                      \
                            p = p - o[idx-r23-1];                       \
                            p = p + o[idx-r23-r3-1];                    \
                        } else if (a == 0) {                            \
                            if (bb == 0) {                              \
                                /* c==0 is the slice's first cell: the  \
                                 * serial decoder passes pred 0 (a      \
                                 * corrupt stream can carry a nonzero   \
                                 * type there) */                       \
                                if (c == 0) p = (FT)0;                  \
                                else if (c == 1) p = o[idx-1];          \
                                else p = (FT)2 * o[idx-1] - o[idx-2];   \
                            } else if (c == 0) {                        \
                                p = o[idx - r3];                        \
                            } else {                                    \
                                p = o[idx-1] + o[idx-r3]                \
                                    - o[idx-r3-1];                      \
                            }                                           \
                        } else if (bb == 0) {                           \
                            if (c == 0) p = o[idx - r23];               \
                            else p = o[idx-1] + o[idx-r23]              \
                                     - o[idx-r23-1];                    \
                        } else {                                        \
                            p = o[idx-r3] + o[idx-r23]                  \
                                - o[idx-r23-r3];                        \
                        }                                               \
                        if (dbl)                                        \
                            o[idx] = (FT)((double)p                     \
                                + (double)(2 * (t - radius)) * rp64);   \
                        else                                            \
                            o[idx] = p + (FT)(2 * (t - radius)) * rp;   \
                    }                                                   \
                }                                                       \
            }                                                           \
        }                                                               \
    }                                                                   \
    free(order); free(dstart); free(zpre); free(rowstart);              \
}

GEN_CLASSIC_WF(f32, float, 4, uint32_t, xenc_add_f32, xdec_next_f32)
GEN_CLASSIC_WF(f64, double, 8, uint64_t, xenc_add_f64, xdec_next_f64)
#undef GEN_CLASSIC_WF

/* Compact byte-FSM: one 16-byte entry per (state, byte) so a decode
 * step costs a single cache line (the 3-array layout above costs up to
 * three).  Entries inline the first two emitted symbols; the rare >2
 * case (codes shorter than 4 bits) re-walks the byte bit-by-bit. */
typedef struct {
    int32_t next;
    int32_t sym0;
    int32_t sym1;
    int16_t cnt;
    int16_t pad;
} fsme2;

void huff_fsm_build2(const int32_t *L, const int32_t *R, const int32_t *C,
                     const uint8_t *T, int64_t n_nodes, uint8_t *tab,
                     uint32_t *packed) {
    /* packed[e] = next_state | cnt<<28 : a 4-byte-per-entry mirror for
     * the count-only speculative pass (fits caches 4x better). */
    fsme2 *t = (fsme2 *)tab;
    #pragma omp parallel for schedule(dynamic, 64)
    for (int64_t s = 0; s < n_nodes; s++) {
        if (T[s]) continue;
        for (int byte = 0; byte < 256; byte++) {
            int32_t st = (int32_t)s;
            int cnt = 0;
            fsme2 e = {0, 0, 0, 0, 0};
            for (int bit = 7; bit >= 0; bit--) {
                st = ((byte >> bit) & 1) ? R[st] : L[st];
                if (T[st]) {
                    if (cnt == 0) e.sym0 = C[st];
                    else if (cnt == 1) e.sym1 = C[st];
                    cnt++;
                    st = 0;
                }
            }
            e.next = st;
            e.cnt = (int16_t)cnt;
            t[s * 256 + byte] = e;
            packed[s * 256 + byte] =
                (uint32_t)st | ((uint32_t)cnt << 28);
        }
    }
}

int64_t huff_fsm_decode2(const uint8_t *tab, const int32_t *L,
                         const int32_t *R, const int32_t *C,
                         const uint8_t *T, const uint8_t *data,
                         int64_t nbytes, int32_t *out, int64_t count) {
    const fsme2 *t = (const fsme2 *)tab;
    int32_t s = 0;
    int64_t k = 0;
    for (int64_t i = 0; i < nbytes; i++) {
        fsme2 e = t[((int64_t)s << 8) | data[i]];
        int c = e.cnt;
        if (c) {
            if (c <= 2 && k + c <= count) {
                out[k] = e.sym0;
                if (c == 2) out[k + 1] = e.sym1;
                k += c;
            } else {
                /* >2 symbols in one byte, or output-tail clamp */
                int32_t st = s;
                uint8_t b = data[i];
                for (int bit = 7; bit >= 0 && k < count; bit--) {
                    st = ((b >> bit) & 1) ? R[st] : L[st];
                    if (T[st]) { out[k++] = C[st]; st = 0; }
                }
            }
            if (k >= count) return k;
        }
        s = e.next;
    }
    return k;
}

/* Speculative chunk-parallel byte-FSM decode.  Huffman byte streams
 * self-synchronize: decoding a chunk from the wrong entry state almost
 * always converges to the true state trajectory within a few bytes.
 * Phase 1 (parallel) decodes every chunk from assumed state 0,
 * count-only, recording the first PROBE per-byte (state, count) pairs.
 * Phase 2 (serial, cheap) chains true entry states: walking a chunk
 * from its true entry until the state matches the probe trajectory
 * yields the chunk's true symbol count without re-decoding it.
 * Phase 3 (parallel) re-decodes each chunk from its true entry state,
 * emitting directly at its true output offset.  Output is bit-identical
 * to huff_fsm_decode2 (which is the fallback for short streams). */

#define FSM_PROBE 4096

static int64_t fsm_emit_range(const fsme2 *t, const int32_t *L,
                              const int32_t *R, const int32_t *C,
                              const uint8_t *T, const uint8_t *data,
                              int64_t lo, int64_t hi, int32_t s,
                              int32_t *out, int64_t k, int64_t count) {
    for (int64_t i = lo; i < hi; i++) {
        fsme2 e = t[((int64_t)s << 8) | data[i]];
        int c = e.cnt;
        if (c) {
            if (c <= 2 && k + c <= count) {
                out[k] = e.sym0;
                if (c == 2) out[k + 1] = e.sym1;
                k += c;
            } else {
                int32_t st = s;
                uint8_t b = data[i];
                for (int bit = 7; bit >= 0 && k < count; bit--) {
                    st = ((b >> bit) & 1) ? R[st] : L[st];
                    if (T[st]) { out[k++] = C[st]; st = 0; }
                }
            }
            if (k >= count) return k;
        }
        s = e.next;
    }
    return k;
}

int64_t huff_fsm_decode_par(const uint8_t *tab, const uint32_t *packed,
                            const int32_t *L,
                            const int32_t *R, const int32_t *C,
                            const uint8_t *T, const uint8_t *data,
                            int64_t nbytes, int32_t *out, int64_t count) {
#ifndef _OPENMP
    return huff_fsm_decode2(tab, L, R, C, T, data, nbytes, out, count);
#else
    int nth = omp_get_max_threads();
    if (nth <= 1 || nbytes < (1 << 19))
        return huff_fsm_decode2(tab, L, R, C, T, data, nbytes, out,
                                count);
    const fsme2 *t = (const fsme2 *)tab;
    int64_t nchunks = (int64_t)nth * 4;
    if (nchunks > 64) nchunks = 64;
    /* nbytes >= 1<<19 and nchunks <= 64 give csize >= 8192 > FSM_PROBE,
     * so the probe window always fits inside a chunk */
    int64_t csize = (nbytes + nchunks - 1) / nchunks;
    int64_t probe_n = FSM_PROBE;
    int32_t *probe_state = malloc(nchunks * probe_n * sizeof(int32_t));
    int64_t *probe_cnt = malloc(nchunks * probe_n * sizeof(int64_t));
    int32_t *exit_state = malloc(nchunks * sizeof(int32_t));
    int64_t *spec_cnt = malloc(nchunks * sizeof(int64_t));
    int64_t *true_cnt = malloc(nchunks * sizeof(int64_t));
    int32_t *true_entry = malloc(nchunks * sizeof(int32_t));
    /* phase 1: speculative count-only decode from state 0 */
    #pragma omp parallel for schedule(static)
    for (int64_t c = 0; c < nchunks; c++) {
        int64_t lo = c * csize;
        int64_t hi = lo + csize < nbytes ? lo + csize : nbytes;
        int32_t *ps = probe_state + c * probe_n;
        int64_t *pc = probe_cnt + c * probe_n;
        int32_t s = 0;
        int64_t k = 0;
        for (int64_t i = lo; i < hi; i++) {
            uint32_t e = packed[((int64_t)s << 8) | data[i]];
            k += e >> 28;
            s = (int32_t)(e & 0x0FFFFFFFu);
            if (i - lo < probe_n) { ps[i - lo] = s; pc[i - lo] = k; }
        }
        exit_state[c] = s;
        spec_cnt[c] = k;
    }
    /* phase 2: chain true entry states through sync points */
    true_entry[0] = 0;
    int ok = 1;
    for (int64_t c = 0; c < nchunks && ok; c++) {
        int32_t te = true_entry[c];
        if (te == 0) {
            true_cnt[c] = spec_cnt[c];
        } else {
            int64_t lo = c * csize;
            int64_t hi = lo + csize < nbytes ? lo + csize : nbytes;
            int64_t pn = hi - lo < probe_n ? hi - lo : probe_n;
            const int32_t *ps = probe_state + c * probe_n;
            const int64_t *pc = probe_cnt + c * probe_n;
            int32_t s = te;
            int64_t k = 0;
            int64_t sync = -1;
            for (int64_t i = 0; i < pn; i++) {
                uint32_t e = packed[((int64_t)s << 8) | data[lo + i]];
                k += e >> 28;
                s = (int32_t)(e & 0x0FFFFFFFu);
                if (s == ps[i]) { sync = i; break; }
            }
            if (sync < 0) { ok = 0; break; }
            true_cnt[c] = k + (spec_cnt[c] - pc[sync]);
        }
        if (c + 1 < nchunks) true_entry[c + 1] = exit_state[c];
    }
    free(probe_state); free(probe_cnt);
    if (!ok) {
        /* pathological stream: no self-sync within the probe window */
        free(exit_state); free(spec_cnt); free(true_cnt);
        free(true_entry);
        return huff_fsm_decode2(tab, L, R, C, T, data, nbytes, out,
                                count);
    }
    /* exclusive-scan offsets */
    int64_t *off = malloc((nchunks + 1) * sizeof(int64_t));
    off[0] = 0;
    for (int64_t c = 0; c < nchunks; c++)
        off[c + 1] = off[c] + true_cnt[c];
    /* phase 3: exact emission at true offsets */
    int64_t total = off[nchunks] < count ? off[nchunks] : count;
    #pragma omp parallel for schedule(static)
    for (int64_t c = 0; c < nchunks; c++) {
        if (off[c] >= count) continue;
        int64_t lo = c * csize;
        int64_t hi = lo + csize < nbytes ? lo + csize : nbytes;
        fsm_emit_range(t, L, R, C, T, data, lo, hi, true_entry[c],
                       out, off[c], off[c + 1] < count ? off[c + 1]
                                                       : count);
    }
    free(exit_state); free(spec_cnt); free(true_cnt); free(true_entry);
    free(off);
    return total;
#endif
}

/* ------------------------------------------------------------------ */
/* Blocked-wavefront MSST19 kernels (multiplicative Lorenzo,           */
/* sz_float_pwr.c:1978-2090 semantics).  Same tile anti-diagonal       */
/* schedule as the classic wavefront; the escape recon is the raw      */
/* bit truncation (state-free), so lead/mid/resi streams are           */
/* re-assembled in raster order after the sweep.  Bit-identical to     */
/* msst19_encode/_decode (which stay as the small-array path).         */
/* rank==2 keeps the float product chains of the 2D kernel; rank==3    */
/* routes products through double temps (both no-ops for f64).        */
/* ------------------------------------------------------------------ */

#define GEN_MSST19_WF(SUF, FT, ESIZE, MASKT, XADD, XNEXT)               \
static inline FT ms_pred_##SUF(const FT *rec, int64_t idx, int64_t a,   \
                               int64_t b, int64_t c, int64_t r3,        \
                               int64_t r23, int rank) {                 \
    if (a > 0 && b > 0 && c > 0) {                                      \
        double num = (double)rec[idx-1] * (double)rec[idx-r3]           \
                   * (double)rec[idx-r23] * (double)rec[idx-r23-r3-1];  \
        double den = (double)rec[idx-r3-1] * (double)rec[idx-r23-r3]    \
                   * (double)rec[idx-r23-1];                            \
        return (FT)(num / den);                                         \
    }                                                                   \
    if (a == 0) {                                                       \
        if (b == 0) {                                                   \
            if (c == 0) return (FT)0;  /* corrupt-stream guard */       \
            if (c == 1) return rec[idx-1];                              \
            if (rank == 2)                                              \
                return (FT)(rec[idx-1] * rec[idx-1]) / rec[idx-2];      \
            return (FT)((double)rec[idx-1] * (double)rec[idx-1]         \
                        / (double)rec[idx-2]);                          \
        }                                                               \
        if (c == 0) return rec[idx - r3];                               \
        if (rank == 2)                                                  \
            return (FT)(rec[idx-1] * rec[idx-r3]) / rec[idx-r3-1];      \
        return (FT)((double)rec[idx-1] * (double)rec[idx-r3]            \
                    / (double)rec[idx-r3-1]);                           \
    }                                                                   \
    if (b == 0) {                                                       \
        if (c == 0) return rec[idx - r23];                              \
        return (FT)((double)rec[idx-1] * (double)rec[idx-r23]           \
                    / (double)rec[idx-r23-1]);                          \
    }                                                                   \
    /* b > 0, c == 0 */                                                 \
    return (FT)((double)rec[idx-r3] * (double)rec[idx-r23]              \
                / (double)rec[idx-r23-r3]);                             \
}                                                                       \
                                                                        \
int64_t msst19_encode_wf_##SUF(                                         \
    const FT *x, int rank, int64_t r1, int64_t r2, int64_t r3,          \
    const uint16_t *table, int64_t base_index, int64_t top_index,       \
    int bits, int64_t row_size, const double *ptable, int req_length,   \
    int bs, int32_t *types, uint8_t *lead, uint8_t *mid,                \
    int64_t *nmid, uint8_t *resi) {                                     \
    int64_t r23 = r2 * r3, n = r1 * r23;                                \
    MASKT mask = (MASKT)xenc_mask(ESIZE, req_length);                   \
    FT *rec = wf_scratch(0, (size_t)n * sizeof(FT));                   \
    int64_t nbx = (r1 + bs - 1) / bs, nby = (r2 + bs - 1) / bs,         \
            nbz = (r3 + bs - 1) / bs;                                   \
    int64_t *dstart, ndiag;                                             \
    int64_t *order = regnd_diag_order3(nbx, nby, nbz, &dstart, &ndiag); \
    for (int64_t d = 0; d < ndiag; d++) {                               \
        int64_t lo = dstart[d], hi = dstart[d + 1];                     \
        _Pragma("omp parallel for schedule(dynamic)")                   \
        for (int64_t bi = lo; bi < hi; bi++) {                          \
            int64_t bk = order[bi];                                     \
            int64_t i = bk / (nby * nbz), rm = bk % (nby * nbz);        \
            int64_t j = rm / nbz, kb = rm % nbz;                        \
            int64_t ox = i * bs, oy = j * bs, oz = kb * bs;             \
            int64_t ex = ox + bs < r1 ? ox + bs : r1;                   \
            int64_t ey = oy + bs < r2 ? oy + bs : r2;                   \
            int64_t ez = oz + bs < r3 ? oz + bs : r3;                   \
            int interior = (ox > 0 && oy > 0 && oz > 0);                \
            for (int64_t a = ox; a < ex; a++)                           \
            for (int64_t b = oy; b < ey; b++) {                         \
                int64_t idx = a * r23 + b * r3 + oz;                    \
                for (int64_t c = oz; c < ez; c++, idx++) {              \
                    FT pred;                                            \
                    if (interior) {                                     \
                        double num = (double)rec[idx-1]                 \
                                   * (double)rec[idx-r3]                \
                                   * (double)rec[idx-r23]               \
                                   * (double)rec[idx-r23-r3-1];         \
                        double den = (double)rec[idx-r3-1]              \
                                   * (double)rec[idx-r23-r3]            \
                                   * (double)rec[idx-r23-1];            \
                        pred = (FT)(num / den);                         \
                    } else {                                            \
                        if (idx == 0) {                                 \
                            types[0] = 0;                               \
                            rec[0] = xtrunc_##SUF(x[0], (FT)0, 1,       \
                                                  mask);                \
                            continue;                                   \
                        }                                               \
                        pred = ms_pred_##SUF(rec, idx, a, b, c, r3,     \
                                             r23, rank);                \
                    }                                                   \
                    FT cur = x[idx];                                    \
                    FT ratio = cur / pred;                              \
                    int st = msst19_lookup((double)ratio, table,        \
                                           base_index, top_index,       \
                                           bits, row_size);             \
                    if (st) {                                           \
                        types[idx] = st;                                \
                        rec[idx] = (FT)(fabs((double)pred)              \
                                        * ptable[st]);                  \
                    } else {                                            \
                        types[idx] = 0;                                 \
                        rec[idx] = xtrunc_##SUF(cur, (FT)0, 1, mask);   \
                    }                                                   \
                }                                                       \
            }                                                           \
        }                                                               \
    }                                                                   \
    free(order); free(dstart);                                          \
    xenc E;                                                             \
    E.esize = ESIZE;                                                    \
    E.req_bytes = req_length / 8; E.resi_len = req_length % 8;          \
    if (E.req_bytes > ESIZE) E.req_bytes = ESIZE;                       \
    memset(E.prev, 0, 8);                                               \
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;                \
    E.resi = resi; E.nresi = 0;                                         \
    for (int64_t idx = 0; idx < n; idx++)                               \
        if (types[idx] == 0) XADD(&E, x[idx], (FT)0, 1, mask);          \
    *nmid = E.nmid;                                                     \
    return E.nlead;                                                     \
}                                                                       \
                                                                        \
void msst19_decode_wf_##SUF(                                            \
    const int32_t *types, int rank, int64_t r1, int64_t r2,             \
    int64_t r3, const double *ptable, int req_length,                   \
    const uint8_t *lead, const uint8_t *mid, const uint8_t *resi,       \
    int64_t nesc, int bs, FT *out) {                                    \
    int64_t r23 = r2 * r3;                                              \
    xdec D;                                                             \
    D.esize = ESIZE;                                                    \
    D.req_bytes = req_length / 8; D.resi_len = req_length % 8;          \
    if (D.req_bytes > ESIZE) D.req_bytes = ESIZE;                       \
    memset(D.prev, 0, 8);                                               \
    D.lead = lead; D.k = 0; D.mid = mid; D.midp = 0;                    \
    D.resi = resi; D.bitp = 0;                                          \
    FT *vals = wf_scratch(2, (size_t)(nesc > 0 ? nesc : 1)             \
                          * sizeof(FT));                                \
    for (int64_t m = 0; m < nesc; m++)                                  \
        vals[m] = XNEXT(&D, (FT)0, 1);                                  \
    int64_t nbx = (r1 + bs - 1) / bs, nby = (r2 + bs - 1) / bs,         \
            nbz = (r3 + bs - 1) / bs;                                   \
    int64_t nrows = r1 * r2;                                            \
    int64_t *zpre, *rowstart;                                           \
    wf_zero_ordinals(types, nrows, r3, nbz, bs, &zpre, &rowstart);      \
    int64_t *dstart, ndiag;                                             \
    int64_t *order = regnd_diag_order3(nbx, nby, nbz, &dstart, &ndiag); \
    for (int64_t d = 0; d < ndiag; d++) {                               \
        int64_t lo = dstart[d], hi = dstart[d + 1];                     \
        _Pragma("omp parallel for schedule(dynamic)")                   \
        for (int64_t bi = lo; bi < hi; bi++) {                          \
            int64_t bk = order[bi];                                     \
            int64_t i = bk / (nby * nbz), rm = bk % (nby * nbz);        \
            int64_t j = rm / nbz, kb = rm % nbz;                        \
            int64_t ox = i * bs, oy = j * bs, oz = kb * bs;             \
            int64_t ex = ox + bs < r1 ? ox + bs : r1;                   \
            int64_t ey = oy + bs < r2 ? oy + bs : r2;                   \
            int64_t ez = oz + bs < r3 ? oz + bs : r3;                   \
            int interior = (ox > 0 && oy > 0 && oz > 0);                \
            for (int64_t a = ox; a < ex; a++)                           \
            for (int64_t b = oy; b < ey; b++) {                         \
                int64_t row = a * r2 + b;                               \
                int64_t ord = rowstart[row]                             \
                              + zpre[row * (nbz + 1) + kb];             \
                int64_t idx = a * r23 + b * r3 + oz;                    \
                for (int64_t c = oz; c < ez; c++, idx++) {              \
                    int t = types[idx];                                 \
                    if (t == 0) { out[idx] = vals[ord++]; continue; }   \
                    FT pred;                                            \
                    if (interior) {                                     \
                        double num = (double)out[idx-1]                 \
                                   * (double)out[idx-r3]                \
                                   * (double)out[idx-r23]               \
                                   * (double)out[idx-r23-r3-1];         \
                        double den = (double)out[idx-r3-1]              \
                                   * (double)out[idx-r23-r3]            \
                                   * (double)out[idx-r23-1];            \
                        pred = (FT)(num / den);                         \
                    } else {                                            \
                        pred = ms_pred_##SUF(out, idx, a, b, c, r3,     \
                                             r23, rank);                \
                    }                                                   \
                    out[idx] = (FT)(fabs((double)pred) * ptable[t]);    \
                }                                                       \
            }                                                           \
        }                                                               \
    }                                                                   \
    free(order); free(dstart); free(zpre); free(rowstart);              \
}

GEN_MSST19_WF(f32, float, 4, uint32_t, xenc_add_f32, xdec_next_f32)
GEN_MSST19_WF(f64, double, 8, uint64_t, xenc_add_f64, xdec_next_f64)
#undef GEN_MSST19_WF

/* ------------------------------------------------------------------ */
/* Blocked-wavefront integer MDQ kernels (sz_[u]int*.c semantics).     */
/* Escapes are fixed-width min-offset values with no cross-escape      */
/* state, so raster-order re-assembly after the tile sweep is exact;   */
/* the 4D "Row-0 data 1" stale-curValue bug is replicated at cell      */
/* (l,0,0,1) of every slice.  Bit-identical to intnd_encode2/decode.   */
/* ------------------------------------------------------------------ */

static inline int64_t iq_wf(double rp, int intervals, int radius,
                            int an_bits, int an_sgn, int dn_bits,
                            int32_t *types, int64_t idx, int64_t cur,
                            int64_t pred) {
    int64_t diff = wrap_bits(cur - pred, dn_bits, 1);
    double itv = (double)(diff < 0 ? -diff : diff) / rp + 1.0;
    if (itv < (double)intervals) {
        if (diff < 0) itv = -itv;
        int t = (int)(itv / 2) + radius;
        types[idx] = t;
        double v = (double)pred + 2.0 * (t - radius) * rp;
        return wrap_bits((int64_t)trunc(v), an_bits, an_sgn);
    }
    types[idx] = 0;
    return wrap_bits(cur, an_bits, an_sgn);
}

int64_t intnd_encode_wf(const uint8_t *x, int in_esize, int in_sgn,
                        int64_t q1, int64_t r1, int64_t r2, int64_t r3,
                        double rp, int intervals, int radius,
                        int an_bits, int an_sgn, int dn_bits,
                        int64_t min_value, int byte_size,
                        int store_esize, int quirk4d, int bs,
                        int32_t *types, uint8_t *exact) {
    int64_t r23 = r2 * r3, vol = r1 * r23;
    int64_t *rec = wf_scratch(0, (size_t)vol * sizeof(int64_t));
    int64_t global_first = ld_int(x, in_esize, in_sgn);
    int64_t nbx = (r1 + bs - 1) / bs, nby = (r2 + bs - 1) / bs,
            nbz = (r3 + bs - 1) / bs;
    int64_t *dstart, ndiag;
    int64_t *order = regnd_diag_order3(nbx, nby, nbz, &dstart, &ndiag);
#define LDW(i_) ld_int(x + (i_) * in_esize, in_esize, in_sgn)
    for (int64_t l = 0; l < q1; l++) {
        int64_t base = l * vol;
        int32_t *tl = types + base;
        for (int64_t d = 0; d < ndiag; d++) {
            int64_t lo = dstart[d], hi = dstart[d + 1];
            _Pragma("omp parallel for schedule(dynamic)")
            for (int64_t bi = lo; bi < hi; bi++) {
                int64_t bk = order[bi];
                int64_t i = bk / (nby * nbz), rm = bk % (nby * nbz);
                int64_t j = rm / nbz, kb = rm % nbz;
                int64_t ox = i * bs, oy = j * bs, oz = kb * bs;
                int64_t ex = ox + bs < r1 ? ox + bs : r1;
                int64_t ey = oy + bs < r2 ? oy + bs : r2;
                int64_t ez = oz + bs < r3 ? oz + bs : r3;
                int interior = (ox > 0 && oy > 0 && oz > 0);
                for (int64_t a = ox; a < ex; a++)
                for (int64_t b = oy; b < ey; b++) {
                    int64_t idx = a * r23 + b * r3 + oz;
                    for (int64_t c = oz; c < ez; c++, idx++) {
                        int64_t pred;
                        if (interior) {
                            pred = wrap_bits(
                                rec[idx-1] + rec[idx-r3] + rec[idx-r23]
                                - rec[idx-r3-1] - rec[idx-r23-r3]
                                - rec[idx-r23-1] + rec[idx-r23-r3-1],
                                an_bits, an_sgn);
                        } else if (a == 0) {
                            if (b == 0) {
                                if (c == 0) {
                                    tl[idx] = 0;
                                    rec[idx] = wrap_bits(
                                        LDW(base), an_bits, an_sgn);
                                    continue;
                                }
                                if (c == 1) {
                                    if (quirk4d) {
                                        /* stale curValue; escape
                                         * stores the GLOBAL first */
                                        int64_t stale = LDW(base);
                                        int64_t df = wrap_bits(
                                            stale - rec[0], dn_bits, 1);
                                        double itv = (double)(df < 0
                                            ? -df : df) / rp + 1.0;
                                        if (itv < (double)intervals) {
                                            if (df < 0) itv = -itv;
                                            int t = (int)(itv / 2)
                                                    + radius;
                                            tl[idx] = t;
                                            double v = (double)rec[0]
                                                + 2.0 * (t - radius)
                                                  * rp;
                                            rec[idx] = wrap_bits(
                                                (int64_t)trunc(v),
                                                an_bits, an_sgn);
                                        } else {
                                            tl[idx] = 0;
                                            rec[idx] = wrap_bits(
                                                global_first, an_bits,
                                                an_sgn);
                                        }
                                        continue;
                                    }
                                    pred = rec[idx-1];
                                } else {
                                    pred = wrap_bits(
                                        2 * rec[idx-1] - rec[idx-2],
                                        an_bits, an_sgn);
                                }
                            } else if (c == 0) {
                                pred = rec[idx - r3];
                            } else {
                                pred = wrap_bits(
                                    rec[idx-1] + rec[idx-r3]
                                    - rec[idx-r3-1], an_bits, an_sgn);
                            }
                        } else if (b == 0) {
                            if (c == 0) pred = rec[idx - r23];
                            else pred = wrap_bits(
                                rec[idx-1] + rec[idx-r23]
                                - rec[idx-r23-1], an_bits, an_sgn);
                        } else if (c == 0) {
                            pred = wrap_bits(
                                rec[idx-r3] + rec[idx-r23]
                                - rec[idx-r23-r3], an_bits, an_sgn);
                        } else {
                            pred = wrap_bits(
                                rec[idx-1] + rec[idx-r3] + rec[idx-r23]
                                - rec[idx-r3-1] - rec[idx-r23-r3]
                                - rec[idx-r23-1] + rec[idx-r23-r3-1],
                                an_bits, an_sgn);
                        }
                        rec[idx] = iq_wf(rp, intervals, radius,
                                         an_bits, an_sgn, dn_bits, tl,
                                         idx, LDW(base + idx), pred);
                    }
                }
            }
        }
    }
    free(order); free(dstart);
    /* escape stream, raster order */
    ienc E;
    E.rp = rp; E.intervals = intervals; E.radius = radius;
    E.an_bits = an_bits; E.an_sgn = an_sgn; E.dn_bits = dn_bits;
    E.min_value = min_value; E.byte_size = byte_size;
    E.store_esize = store_esize;
    E.exact = exact; E.ecnt = 0;
    for (int64_t l = 0; l < q1; l++) {
        int64_t base = l * vol;
        for (int64_t idx = 0; idx < vol; idx++) {
            if (types[base + idx] != 0) continue;
            if (quirk4d && idx == 1) ienc_store(&E, global_first);
            else ienc_store(&E, LDW(base + idx));
        }
    }
#undef LDW
    return E.ecnt;
}

void intnd_decode_wf(const int32_t *types, int64_t q1, int64_t r1,
                     int64_t r2, int64_t r3, double interval2,
                     int radius, int t_bits, int t_sgn,
                     int64_t min_value, int byte_size, int store_esize,
                     const uint8_t *exact, int bs, int64_t *out) {
    int64_t r23 = r2 * r3, vol = r1 * r23, n = q1 * vol;
    uint64_t mask = (store_esize >= 8) ? ~0ull
                    : ((~0ull) >> (64 - 8 * store_esize));
    int64_t nbx = (r1 + bs - 1) / bs, nby = (r2 + bs - 1) / bs,
            nbz = (r3 + bs - 1) / bs;
    int64_t nrows = n / r3;
    int64_t *zpre, *rowstart;
    wf_zero_ordinals(types, nrows, r3, nbz, bs, &zpre, &rowstart);
    int64_t *dstart, ndiag;
    int64_t *order = regnd_diag_order3(nbx, nby, nbz, &dstart, &ndiag);
    for (int64_t l = 0; l < q1; l++) {
        const int32_t *tl = types + l * vol;
        int64_t *o = out + l * vol;
        for (int64_t d = 0; d < ndiag; d++) {
            int64_t lo = dstart[d], hi = dstart[d + 1];
            _Pragma("omp parallel for schedule(dynamic)")
            for (int64_t bi = lo; bi < hi; bi++) {
                int64_t bk = order[bi];
                int64_t i = bk / (nby * nbz), rm = bk % (nby * nbz);
                int64_t j = rm / nbz, kb = rm % nbz;
                int64_t ox = i * bs, oy = j * bs, oz = kb * bs;
                int64_t ex = ox + bs < r1 ? ox + bs : r1;
                int64_t ey = oy + bs < r2 ? oy + bs : r2;
                int64_t ez = oz + bs < r3 ? oz + bs : r3;
                int interior = (ox > 0 && oy > 0 && oz > 0);
                for (int64_t a = ox; a < ex; a++)
                for (int64_t b = oy; b < ey; b++) {
                    int64_t row = (l * r1 + a) * r2 + b;
                    int64_t ord = rowstart[row]
                                  + zpre[row * (nbz + 1) + kb];
                    int64_t idx = a * r23 + b * r3 + oz;
                    for (int64_t c = oz; c < ez; c++, idx++) {
                        int t = tl[idx];
                        if (t == 0) {
                            uint64_t v = 0;
                            const uint8_t *p = exact
                                + ord * byte_size;
                            for (int bb = 0; bb < byte_size; bb++)
                                v = (v << 8) | p[bb];
                            v = (v + (uint64_t)min_value) & mask;
                            o[idx] = wrap_bits((int64_t)v, t_bits,
                                               t_sgn);
                            ord++;
                            continue;
                        }
                        int64_t pred;
                        if (interior) {
                            pred = o[idx-1] + o[idx-r3] + o[idx-r23]
                                 - o[idx-r3-1] - o[idx-r23-r3]
                                 - o[idx-r23-1] + o[idx-r23-r3-1];
                        } else if (a == 0) {
                            if (b == 0) {
                                /* slice-first cell: serial decoder
                                 * passes pred 0 (corrupt-stream
                                 * guard) */
                                if (c == 0) pred = 0;
                                else if (c == 1) pred = o[idx-1];
                                else pred = 2 * o[idx-1] - o[idx-2];
                            } else if (c == 0) {
                                pred = o[idx - r3];
                            } else {
                                pred = o[idx-1] + o[idx-r3]
                                     - o[idx-r3-1];
                            }
                        } else if (b == 0) {
                            if (c == 0) pred = o[idx - r23];
                            else pred = o[idx-1] + o[idx-r23]
                                      - o[idx-r23-1];
                        } else if (c == 0) {
                            pred = o[idx-r3] + o[idx-r23]
                                 - o[idx-r23-r3];
                        } else {
                            pred = o[idx-1] + o[idx-r3] + o[idx-r23]
                                 - o[idx-r3-1] - o[idx-r23-r3]
                                 - o[idx-r23-1] + o[idx-r23-r3-1];
                        }
                        o[idx] = wrap_bits(
                            (int64_t)trunc((double)pred
                                           + (t - radius) * interval2),
                            t_bits, t_sgn);
                    }
                }
            }
        }
    }
    free(order); free(dstart); free(zpre); free(rowstart);
}
