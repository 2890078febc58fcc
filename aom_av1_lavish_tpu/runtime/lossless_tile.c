/* Native lossless tile walker: full partition walk + symbol emission.
 *
 * The device analyze (ops/lossless.py) computes every 4x4 block's quantized
 * WHT coefficients in one batched jit call; this module performs the
 * remaining sequential per-tile work natively: fixed partition walk,
 * skip/mode symbol emission, per-txb entropy contexts, and coefficient
 * coding.  Mirrors encoder/encoder.py (LosslessEncoder) byte-exactly —
 * tested in tests/test_native_entropy.py::test_lossless_walker_native.
 *
 * Reference behavior being mirrored: av1/encoder/encodeframe.c block walk
 * + bitstream.c write_modes (KEY frame, lossless, DC-only path).
 *
 * Unity build: pulls in the range coder + txb coder from entropy_enc.c.
 */

#include "entropy_enc.c"

/* AV1 block-size enum (av1/common/enums.h:100) — normative, stable */
enum {
  B4X4, B4X8, B8X4, B8X8, B8X16, B16X8, B16X16, B16X32, B32X16, B32X32,
  B32X64, B64X32, B64X64, B64X128, B128X64, B128X128, B4X16, B16X4,
  B8X32, B32X8, B16X64, B64X16, B_INVALID
};
enum { P_NONE, P_HORZ, P_VERT, P_SPLIT };

static const uint8_t BW_PX[22] = {4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32,
                                  64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64};
static const uint8_t BH_PX[22] = {4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64,
                                  32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16};

static int bsize_of_dims(int w, int h) {
  for (int i = 0; i < 22; i++)
    if (BW_PX[i] == w && BH_PX[i] == h) return i;
  return B_INVALID;
}

static int lt_subsize(int bsize, int partition) {
  int w = BW_PX[bsize], h = BH_PX[bsize];
  switch (partition) {
    case P_NONE: return bsize;
    case P_HORZ: return bsize_of_dims(w, h / 2);
    case P_VERT: return bsize_of_dims(w / 2, h);
    default: return bsize_of_dims(w / 2, h / 2);
  }
}

static int ilog2i(int v) { /* floor(log2(v)), v >= 1 */
  int r = 0;
  while (v > 1) { v >>= 1; r++; }
  return r;
}

static const int8_t SKIP_CONTEXTS[5][5] = {{1, 2, 2, 2, 3},
                                           {2, 4, 4, 4, 5},
                                           {2, 4, 4, 4, 5},
                                           {2, 4, 4, 4, 5},
                                           {3, 5, 5, 5, 6}};

/* dc-sign contribution of an entropy-context byte (sign code in bits 6+) */
static int dc_sign_of(int v) {
  if (v >= (2 << 6)) return 1;
  if (v >= (1 << 6)) return -1;
  return 0;
}

typedef struct {
  const int32_t *q[3]; /* per-plane (h4, w4, 16) int32 */
  int w4[3];           /* blocks-per-row stride per plane */
  int mi_rows, mi_cols;
  int num_planes;
  uint16_t *arena;
  /* offs: [part_base, part_stride, skip_base, kf_y_off, uv_off0, uv_off1] */
  const int32_t *offs;
  const int32_t *cdfsets; /* 2 rows x 8: plane_type 0 / 1, TX_4X4 */
  const int16_t *scan4;
  uint8_t *above_part, *left_part;
  uint8_t *ae[3], *le[3];
  uint8_t *mi_skip; /* mi_rows * mi_cols */
  RangeEnc e;
  int16_t levels[8 * 8];
} LT;

static int lt_choose_partition(LT *t, int mi_row, int mi_col, int bsize) {
  int bw = BW_PX[bsize] >> 2;
  int hbs = bw / 2;
  if (bsize < B8X8) return P_NONE;
  int fits_rows = mi_row + bw <= t->mi_rows;
  int fits_cols = mi_col + bw <= t->mi_cols;
  if (fits_rows && fits_cols) return P_NONE;
  int has_rows = mi_row + hbs < t->mi_rows;
  int has_cols = mi_col + hbs < t->mi_cols;
  if (!has_rows && fits_cols) return P_HORZ;
  if (!has_cols && fits_rows) return P_VERT;
  return P_SPLIT;
}

static void lt_write_partition(LT *t, int mi_row, int mi_col, int bsize,
                               int partition) {
  int hbs = (BW_PX[bsize] >> 2) / 2;
  int has_rows = mi_row + hbs < t->mi_rows;
  int has_cols = mi_col + hbs < t->mi_cols;
  if (!has_rows && !has_cols) return; /* implicit SPLIT */
  int bsl = ilog2i(BW_PX[bsize] >> 2) - 1;
  int above = (t->above_part[mi_col] >> bsl) & 1;
  int left = (t->left_part[mi_row] >> bsl) & 1;
  int ctx = (left * 2 + above) + bsl * 4;
  uint16_t *cdf = t->arena + t->offs[0] + ctx * t->offs[1];
  if (has_rows && has_cols) {
    int n = bsize == B8X8 ? 4 : 10;
    enc_symbol(&t->e, cdf, partition, n, 1);
  } else {
    enc_gather_split(&t->e, cdf, 0, !has_cols, partition == P_SPLIT);
  }
}

static void lt_update_ext_ctx(LT *t, int mi_row, int mi_col, int subsize,
                              int bsize, int partition) {
  if (bsize < B8X8) return;
  if (partition == P_SPLIT && bsize != B8X8) return;
  int bw = BW_PX[bsize] >> 2, bh = BH_PX[bsize] >> 2;
  int sub_w4 = BW_PX[subsize] >> 2, sub_h4 = BH_PX[subsize] >> 2;
  uint8_t above = (uint8_t)((31 << ilog2i(sub_w4)) & 31);
  uint8_t left = (uint8_t)((31 << ilog2i(sub_h4)) & 31);
  memset(t->above_part + mi_col, above, (size_t)bw);
  memset(t->left_part + mi_row, left, (size_t)bh);
}

/* iterate the txbs of one block in coding order, calling cb per txb */
typedef void (*txb_cb)(LT *t, int plane, int py, int px, int plane_bsize,
                       void *ctx);

static void lt_foreach_txb(LT *t, int mi_row, int mi_col, int bsize,
                           int chroma_ref, txb_cb cb, void *cbctx) {
  int bw = BW_PX[bsize] >> 2, bh = BH_PX[bsize] >> 2;
  int nplanes = chroma_ref ? t->num_planes : 1;
  for (int plane = 0; plane < nplanes; plane++) {
    int ss = plane ? 1 : 0;
    int pbw = plane ? (BW_PX[bsize] >> 1 < 4 ? 4 : BW_PX[bsize] >> 1)
                    : BW_PX[bsize];
    int pbh = plane ? (BH_PX[bsize] >> 1 < 4 ? 4 : BH_PX[bsize] >> 1)
                    : BH_PX[bsize];
    int plane_bsize = plane ? bsize_of_dims(pbw, pbh) : bsize;
    int row0 = plane ? (((mi_row - (mi_row & 1)) * 4) >> 1) : mi_row * 4;
    int col0 = plane ? (((mi_col - (mi_col & 1)) * 4) >> 1) : mi_col * 4;
    int mb_to_right = (t->mi_cols - bw - mi_col) * 4;
    int mb_to_bottom = (t->mi_rows - bh - mi_row) * 4;
    int vis_w = pbw + ((mb_to_right < 0 ? mb_to_right : 0) >> ss);
    int vis_h = pbh + ((mb_to_bottom < 0 ? mb_to_bottom : 0) >> ss);
    int n4w = vis_w >> 2 > 1 ? vis_w >> 2 : 1;
    int n4h = vis_h >> 2 > 1 ? vis_h >> 2 : 1;
    for (int r4 = 0; r4 < n4h; r4++)
      for (int c4 = 0; c4 < n4w; c4++)
        cb(t, plane, row0 + r4 * 4, col0 + c4 * 4, plane_bsize, cbctx);
  }
}

static void cb_check_zero(LT *t, int plane, int py, int px, int plane_bsize,
                          void *ctx) {
  (void)plane_bsize;
  int *all_zero = (int *)ctx;
  if (!*all_zero) return;
  const int32_t *q =
      t->q[plane] + ((size_t)(py >> 2) * t->w4[plane] + (px >> 2)) * 16;
  for (int i = 0; i < 16; i++)
    if (q[i]) { *all_zero = 0; return; }
}

typedef struct { int skip; } EmitCtx;

static void cb_emit_txb(LT *t, int plane, int py, int px, int plane_bsize,
                        void *ctxp) {
  EmitCtx *ec = (EmitCtx *)ctxp;
  int acol = px >> 2, lrow = py >> 2;
  uint8_t *au = t->ae[plane], *lu = t->le[plane];
  if (ec->skip) {
    au[acol] = 0;
    lu[lrow] = 0;
    return;
  }
  int a = au[acol], l = lu[lrow];
  int ds = dc_sign_of(a) + dc_sign_of(l);
  int dc_sign_ctx = ds == 0 ? 0 : (ds < 0 ? 1 : 2);
  int skip_ctx;
  if (plane == 0) {
    if (plane_bsize == B4X4)
      skip_ctx = 0;
    else {
      int top = (a & COEFF_CONTEXT_MASK) < 4 ? (a & COEFF_CONTEXT_MASK) : 4;
      int left = (l & COEFF_CONTEXT_MASK) < 4 ? (l & COEFF_CONTEXT_MASK) : 4;
      skip_ctx = SKIP_CONTEXTS[top][left];
    }
  } else {
    skip_ctx = (a != 0) + (l != 0) + (plane_bsize == B4X4 ? 7 : 10);
  }
  const int32_t *q =
      t->q[plane] + ((size_t)(py >> 2) * t->w4[plane] + (px >> 2)) * 16;
  int cul = code_txb(&t->e, t->arena, t->cdfsets + (plane ? 8 : 0), q,
                     t->scan4, 4, 4, 2, 0, 4, 4, 0, skip_ctx, dc_sign_ctx,
                     -1, 0, 0, t->levels);
  au[acol] = (uint8_t)cul;
  lu[lrow] = (uint8_t)cul;
}

static void lt_encode_block(LT *t, int mi_row, int mi_col, int bsize) {
  int bw = BW_PX[bsize] >> 2, bh = BH_PX[bsize] >> 2;
  /* is_chroma_reference (blockd.py:75), ss_x = ss_y = 1 */
  int chroma_ref = t->num_planes > 1 &&
                   ((mi_row & 1) || !(bh & 1)) && ((mi_col & 1) || !(bw & 1));
  int all_zero = 1;
  lt_foreach_txb(t, mi_row, mi_col, bsize, chroma_ref, cb_check_zero,
                 &all_zero);
  int skip = all_zero;

  int skip_ctx =
      (mi_row > 0 ? t->mi_skip[(mi_row - 1) * t->mi_cols + mi_col] : 0) +
      (mi_col > 0 ? t->mi_skip[mi_row * t->mi_cols + mi_col - 1] : 0);
  enc_symbol(&t->e, t->arena + t->offs[2] + skip_ctx * 3, skip, 2, 1);
  /* kf y mode: DC (ctx row (0,0) since all neighbors are DC) */
  enc_symbol(&t->e, t->arena + t->offs[3], 0, 13, 1);
  if (chroma_ref) {
    int cfl_allowed = (BW_PX[bsize] <= 8 && BH_PX[bsize] <= 8);
    enc_symbol(&t->e, t->arena + t->offs[4 + cfl_allowed], 0,
               14 - !cfl_allowed, 1);
  }
  int rmax = mi_row + bh < t->mi_rows ? mi_row + bh : t->mi_rows;
  int cmax = mi_col + bw < t->mi_cols ? mi_col + bw : t->mi_cols;
  for (int r = mi_row; r < rmax; r++)
    memset(t->mi_skip + r * t->mi_cols + mi_col, skip,
           (size_t)(cmax - mi_col));

  EmitCtx ec = {skip};
  lt_foreach_txb(t, mi_row, mi_col, bsize, chroma_ref, cb_emit_txb, &ec);
}

static void lt_encode_partition(LT *t, int mi_row, int mi_col, int bsize) {
  if (mi_row >= t->mi_rows || mi_col >= t->mi_cols) return;
  int bw = BW_PX[bsize] >> 2;
  int hbs = bw / 2;
  int partition = lt_choose_partition(t, mi_row, mi_col, bsize);
  if (bsize >= B8X8) lt_write_partition(t, mi_row, mi_col, bsize, partition);
  int subsize = lt_subsize(bsize, partition);
  switch (partition) {
    case P_NONE:
      lt_encode_block(t, mi_row, mi_col, subsize);
      break;
    case P_HORZ:
      lt_encode_block(t, mi_row, mi_col, subsize);
      if (mi_row + hbs < t->mi_rows)
        lt_encode_block(t, mi_row + hbs, mi_col, subsize);
      break;
    case P_VERT:
      lt_encode_block(t, mi_row, mi_col, subsize);
      if (mi_col + hbs < t->mi_cols)
        lt_encode_block(t, mi_row, mi_col + hbs, subsize);
      break;
    default:
      lt_encode_partition(t, mi_row, mi_col, subsize);
      lt_encode_partition(t, mi_row, mi_col + hbs, subsize);
      lt_encode_partition(t, mi_row + hbs, mi_col, subsize);
      lt_encode_partition(t, mi_row + hbs, mi_col + hbs, subsize);
      break;
  }
  lt_update_ext_ctx(t, mi_row, mi_col, subsize, bsize, partition);
}

/* Encode one lossless tile covering mi rows [0, mi_rows) x cols
 * [0, mi_cols).  q*: (h4, w4, 16) int32 per plane (w4y/w4c strides);
 * offs: arena offsets [part_base, part_stride, skip_base, kf_y_row00,
 * uv_row_nocfl, uv_row_cfl]; cdfsets: 2x8 int32 (plane types 0/1 at
 * TX_4X4); scan4: 16-entry default scan.  Returns byte length in out. */
int avl_encode_lossless_tile(const int32_t *qy, const int32_t *qu,
                             const int32_t *qv, int mi_rows, int mi_cols,
                             int w4y, int w4c, int num_planes,
                             uint16_t *arena, const int32_t *offs,
                             const int32_t *cdfsets, const int16_t *scan4,
                             int sb_mi, uint8_t *out, int out_cap) {
  LT t;
  memset(&t, 0, sizeof(t));
  t.q[0] = qy;
  t.q[1] = qu;
  t.q[2] = qv;
  t.w4[0] = w4y;
  t.w4[1] = w4c;
  t.w4[2] = w4c;
  t.mi_rows = mi_rows;
  t.mi_cols = mi_cols;
  t.num_planes = num_planes;
  t.arena = arena;
  t.offs = offs;
  t.cdfsets = cdfsets;
  t.scan4 = scan4;
  size_t apn = (size_t)mi_cols + 32, lpn = (size_t)mi_rows + 32;
  uint8_t *mem = (uint8_t *)calloc(
      apn + lpn + 3 * (apn + lpn) + (size_t)mi_rows * mi_cols, 1);
  if (!mem) return -1;
  uint8_t *p = mem;
  t.above_part = p;
  p += apn;
  t.left_part = p;
  p += lpn;
  for (int i = 0; i < 3; i++) {
    t.ae[i] = p;
    p += apn;
    t.le[i] = p;
    p += lpn;
  }
  t.mi_skip = p;
  re_init(&t.e, out, (size_t)out_cap);
  for (int mi_row = 0; mi_row < mi_rows; mi_row += sb_mi) {
    memset(t.left_part, 0, lpn);
    for (int i = 0; i < 3; i++) memset(t.le[i], 0, lpn);
    for (int mi_col = 0; mi_col < mi_cols; mi_col += sb_mi)
      lt_encode_partition(&t, mi_row, mi_col,
                          sb_mi == 32 ? B128X128 : B64X64);
  }
  int n = (int)re_done(&t.e);
  free(mem);
  return n;
}
