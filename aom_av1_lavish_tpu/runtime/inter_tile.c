/* Native inter tile walker for the device-batched P-frame path.
 *
 * The device chain program (ops/inter_tpu.py) produces every 16x16 block's
 * motion vector, reference pick and quantized coefficients in one batched
 * device program; this module performs the remaining sequential per-tile
 * work natively: forced-split partition walk, skip / intra_inter /
 * single-ref / inter-mode symbols, the spatial ref-MV stack
 * (av1_find_mv_refs, av1/common/mvref_common.c:783 — restricted to the
 * uniform 16x16 single-ref geometry this path emits), MV coding
 * (av1/encoder/encodemv.c), and coefficient coding.  Mirrors, byte
 * exactly, the Python emitter (encoder/inter.py _emit_block +
 * common/mvref.py) — pinned by tests/test_native_entropy.py and the
 * decode-conformance suites.
 *
 * Restrictions (the Python path remains the general emitter): all blocks
 * 16x16 NEWMV-class single-ref inter, no skip-mode / delta-q /
 * segmentation / motion modes / interintra / compound, TX_MODE_LARGEST,
 * identity global motion, no temporal MVP, single tile.
 *
 * Unity build: pulls in the range coder + txb coder from entropy_enc.c
 * (same scheme as lossless_tile.c).
 */

#define AVL_NO_TILE_ENTRY /* avl_encode_tile lives in lossless_tile's TU */
#include "entropy_enc.c"

#define MI_M 8 /* mi-grid margin (scan offsets reach -6; top-right +4) */

enum { IT_NEARESTMV = 13, IT_NEARMV, IT_GLOBALMV, IT_NEWMV };

/* dc-sign contribution of an entropy-context byte (sign in bits 6+) */
static int dc_sign_of(int v) {
  if (v >= (2 << 6)) return 1;
  if (v >= (1 << 6)) return -1;
  return 0;
}
#define REF_CAT_LEVEL 640
#define MAX_STACK 8
#define MV_BORDER (16 << 3)

/* offs[] layout (filled by runtime/__init__.py encode_inter16_tile):
 *  0 partition_base  1 partition_stride
 *  2 skip_base (stride 3)
 *  3 intra_inter_base (stride 3)
 *  4 single_ref_base  5 single_ref_s0  6 single_ref_s1 (row 3)
 *  7 newmv_base  8 zeromv_base  9 refmv_base  10 drl_base (stride 3)
 *  11 joints
 *  12+9k (k=comp 0/1): sign, classes, class0, bits_base, class0_fp_base,
 *                      fp, class0_hp, hp, (pad)
 *  30 txtype_off  31 txtype_nsymbs  32 txtype_sym
 *  33 allow_hp
 */

typedef struct {
  int mi_rows, mi_cols, sb_mi;
  const int16_t *res; /* (B, 390) int16: 16x16 leaves */
  int nbx;            /* 16px blocks per row */
  /* variable-partition extension (NULL lvl = uniform 16x16):
   * lvl (nby, nbx) uint8 0/1/2 = 16/32/64 leaf; res32 (B32, 1542) and
   * res64 (B64, 3078) raster rows for the merged leaves */
  const uint8_t *lvl;
  const int16_t *res32, *res64;
  int nbx2, nbx4;
  const int16_t *scan32; /* TX_32X32 default scan (shared by TX_64X64) */
  int ref_lut[2];
  const int8_t *sign_bias; /* [8] */
  uint16_t *arena;
  const int32_t *o;
  /* cdfset rows x 8: 0 luma TX_16X16, 1 chroma TX_8X8, 2 luma TX_32X32,
   * 3 chroma TX_16X16, 4 luma TX_64X64, 5 chroma TX_32X32 */
  const int32_t *cdfsets;
  const int16_t *scan16, *scan8;
  uint8_t *above_part, *left_part;
  uint8_t *ae[3], *le[3];
  uint8_t *mi_skip;
  /* mi grids with margin: ref (0 = intra/unset), mode, mv row/col,
   * covering-block width in mi units (0 = unset) */
  int8_t *g_ref;
  uint8_t *g_mode;
  int16_t *g_mvr, *g_mvc;
  uint8_t *g_bw4;
  int gw; /* grid row stride = mi_cols + 2*MI_M */
  RangeEnc e;
  int16_t levels[36 * 36];
  int32_t q32[1024];
} IT;

static inline int g_at(const IT *t, int r, int c0) {
  return (r + MI_M) * t->gw + (c0 + MI_M);
}

/* ---- candidate stack ------------------------------------------------ */

typedef struct {
  int16_t mvr[MAX_STACK], mvc[MAX_STACK];
  int32_t w[MAX_STACK];
  int count;
  int newmv_count;
} Stack;

static void add_cand(IT *t, Stack *s, int gi, int ref_frame, int weight,
                     int *match) {
  int ref0 = t->g_ref[gi];
  if (ref0 <= 0) return; /* intra / unset */
  if (ref0 != ref_frame) return;
  int mr = t->g_mvr[gi], mc = t->g_mvc[gi];
  for (int i = 0; i < s->count; i++) {
    if (s->mvr[i] == mr && s->mvc[i] == mc) {
      s->w[i] += weight;
      goto matched;
    }
  }
  if (s->count < MAX_STACK) {
    s->mvr[s->count] = (int16_t)mr;
    s->mvc[s->count] = (int16_t)mc;
    s->w[s->count] = weight;
    s->count++;
  }
matched:
  if (t->g_mode[gi] == IT_NEWMV) s->newmv_count++;
  *match += 1;
}

static int has_top_right(const IT *t, int mi_row, int mi_col, int bw4) {
  int bs = bw4; /* square blocks: bs = max(w4, h4) */
  int mask_row = mi_row & (t->sb_mi - 1);
  int mask_col = mi_col & (t->sb_mi - 1);
  if (bs > 16) return 0;
  int has_tr = !((mask_row & bs) && (mask_col & bs));
  for (int b = bs; b < t->sb_mi; b <<= 1) {
    if (mask_col & b) {
      if ((mask_col & (2 * b)) && (mask_row & (2 * b))) {
        has_tr = 0;
        break;
      }
    } else {
      break;
    }
  }
  return has_tr;
}

static void lower_prec(int allow_hp, int *r, int *c0) {
  if (!allow_hp) {
    if (*r & 1) *r += (*r > 0) ? -1 : 1;
    if (*c0 & 1) *c0 += (*c0 > 0) ? -1 : 1;
  }
}

static void clamp_ref_mv(const IT *t, int mi_row, int mi_col, int bw4,
                         int *r, int *c0) {
  /* _clamp_mv_ref (mvref.py:307), square bw4-mi block */
  int bw = bw4 * 4, bh = bw4 * 4;
  int mb_to_left = -(mi_col * 4) * 8;
  int mb_to_right = (t->mi_cols - bw4 - mi_col) * 4 * 8;
  int mb_to_top = -(mi_row * 4) * 8;
  int mb_to_bottom = (t->mi_rows - bw4 - mi_row) * 4 * 8;
  int lo_c = mb_to_left - bw * 8 - MV_BORDER;
  int hi_c = mb_to_right + bw * 8 + MV_BORDER;
  int lo_r = mb_to_top - bh * 8 - MV_BORDER;
  int hi_r = mb_to_bottom + bh * 8 + MV_BORDER;
  if (*r < lo_r) *r = lo_r;
  if (*r > hi_r) *r = hi_r;
  if (*c0 < lo_c) *c0 = lo_c;
  if (*c0 > hi_c) *c0 = hi_c;
}

/* neighbor block width in mi units at a margin-grid index (unset /
 * out-of-frame cells read 1, matching _mi_wide(BLOCK_4X4) on the Python
 * margin grid) */
static inline int nb_w4(const IT *t, int gi) {
  int w = t->g_bw4[gi];
  return w > 0 ? w : 1;
}

/* _scan_row (mvref.py:235): walk the row at row_offset across the block
 * width, stepping by each neighbor's width. */
static void scan_row(IT *t, int mi_row, int mi_col, int bw4, int ref_frame,
                     int row_offset, Stack *s, int *match,
                     int max_row_offset, int *processed_rows) {
  int end_mi = bw4;
  if (end_mi > t->mi_cols - mi_col) end_mi = t->mi_cols - mi_col;
  if (end_mi > 16) end_mi = 16;
  int col_offset = (row_offset < -1) ? 1 : 0;
  int use_step_16 = bw4 >= 16;
  int i = 0;
  while (i < end_mi) {
    int gi = g_at(t, mi_row + row_offset, mi_col + col_offset + i);
    int n4w = nb_w4(t, gi);
    int len = bw4 < n4w ? bw4 : n4w;
    if (use_step_16) {
      if (len < 4) len = 4;
    } else if (row_offset < -1 && len < 2) {
      len = 2;
    }
    int weight = 2;
    if (2 <= bw4 && bw4 <= n4w) {
      int inc = -max_row_offset + row_offset + 1;
      if (inc > n4w) inc = n4w; /* square neighbors: n4h == n4w */
      if (weight < inc) weight = inc;
      *processed_rows = inc - row_offset - 1;
    }
    add_cand(t, s, gi, ref_frame, len * weight, match);
    i += len;
  }
}

/* _scan_col (mvref.py:264) */
static void scan_col(IT *t, int mi_row, int mi_col, int bh4, int ref_frame,
                     int col_offset, Stack *s, int *match,
                     int max_col_offset, int *processed_cols) {
  int end_mi = bh4;
  if (end_mi > t->mi_rows - mi_row) end_mi = t->mi_rows - mi_row;
  if (end_mi > 16) end_mi = 16;
  int row_offset = (col_offset < -1) ? 1 : 0;
  int use_step_16 = bh4 >= 16;
  int i = 0;
  while (i < end_mi) {
    int gi = g_at(t, mi_row + row_offset + i, mi_col + col_offset);
    int n4h = nb_w4(t, gi);
    int len = bh4 < n4h ? bh4 : n4h;
    if (use_step_16) {
      if (len < 4) len = 4;
    } else if (col_offset < -1 && len < 2) {
      len = 2;
    }
    int weight = 2;
    if (2 <= bh4 && bh4 <= n4h) {
      int inc = -max_col_offset + col_offset + 1;
      if (inc > n4h) inc = n4h;
      if (weight < inc) weight = inc;
      *processed_cols = inc - col_offset - 1;
    }
    add_cand(t, s, gi, ref_frame, len * weight, match);
    i += len;
  }
}

/* av1_find_mv_refs for the square {16,32,64} single-ref inter grid,
 * spatial only, identity GM.  Returns mode_context; fills stack +
 * nearest/near. */
static int find_mv_refs(IT *t, int mi_row, int mi_col, int bw4,
                        int ref_frame, Stack *s, int *nearest_r,
                        int *nearest_c, int *near_r, int *near_c,
                        int allow_hp) {
  s->count = 0;
  s->newmv_count = 0;
  int row_match = 0, col_match = 0;
  int up = mi_row > 0, left = mi_col > 0;
  int max_row_offset = 0, max_col_offset = 0;
  if (up) {
    max_row_offset = -(3 << 1); /* MVREF_ROW_COLS = 3 */
    if (max_row_offset < -mi_row) max_row_offset = -mi_row;
  }
  if (left) {
    max_col_offset = -(3 << 1);
    if (max_col_offset < -mi_col) max_col_offset = -mi_col;
  }
  int processed_rows = 0, processed_cols = 0;

  if (max_row_offset <= -1)
    scan_row(t, mi_row, mi_col, bw4, ref_frame, -1, s, &row_match,
             max_row_offset, &processed_rows);
  if (max_col_offset <= -1)
    scan_col(t, mi_row, mi_col, bw4, ref_frame, -1, s, &col_match,
             max_col_offset, &processed_cols);
  if (has_top_right(t, mi_row, mi_col, bw4) && mi_row >= 1 &&
      mi_col + bw4 < t->mi_cols)
    add_cand(t, s, g_at(t, mi_row - 1, mi_col + bw4), ref_frame, 4,
             &row_match);

  int nearest_match = (row_match > 0) + (col_match > 0);
  int nearest_count = s->count;
  int newmv_count = s->newmv_count;
  for (int i = 0; i < nearest_count; i++) s->w[i] += REF_CAT_LEVEL;

  /* outer area: top-left blk + rows/cols -3, -5 (skipped whenever the
   * processed_rows/cols bookkeeping says the nearest scan covered them) */
  if (mi_row >= 1 && mi_col >= 1)
    add_cand(t, s, g_at(t, mi_row - 1, mi_col - 1), ref_frame, 4,
             &row_match);
  for (int idx = 2; idx <= 3; idx++) {
    int row_offset = -(idx << 1) + 1;
    int col_offset = -(idx << 1) + 1;
    if (-row_offset <= -max_row_offset && -row_offset > processed_rows)
      scan_row(t, mi_row, mi_col, bw4, ref_frame, row_offset, s,
               &row_match, max_row_offset, &processed_rows);
    if (-col_offset <= -max_col_offset && -col_offset > processed_cols)
      scan_col(t, mi_row, mi_col, bw4, ref_frame, col_offset, s,
               &col_match, max_col_offset, &processed_cols);
  }

  int ref_match_count = (row_match > 0) + (col_match > 0);
  int mode_context = 0;
  if (nearest_match == 0) {
    if (ref_match_count >= 1) mode_context |= 1;
    if (ref_match_count == 1)
      mode_context |= 1 << 4;
    else if (ref_match_count >= 2)
      mode_context |= 2 << 4;
  } else if (nearest_match == 1) {
    mode_context |= newmv_count > 0 ? 2 : 3;
    if (ref_match_count == 1)
      mode_context |= 3 << 4;
    else if (ref_match_count >= 2)
      mode_context |= 4 << 4;
  } else {
    mode_context |= newmv_count >= 1 ? 4 : 5;
    mode_context |= 5 << 4;
  }

  /* stable partial bubble sorts (mvref_common.c:641) */
  for (int pass = 0; pass < 2; pass++) {
    int start = pass == 0 ? 0 : nearest_count;
    int len = pass == 0 ? nearest_count : s->count;
    int ln = len;
    while (ln > start) {
      int nr = start;
      for (int i = start + 1; i < ln; i++) {
        if (s->w[i - 1] < s->w[i]) {
          int16_t tr = s->mvr[i - 1], tc = s->mvc[i - 1];
          int32_t tw = s->w[i - 1];
          s->mvr[i - 1] = s->mvr[i];
          s->mvc[i - 1] = s->mvc[i];
          s->w[i - 1] = s->w[i];
          s->mvr[i] = tr;
          s->mvc[i] = tc;
          s->w[i] = tw;
          nr = i;
        }
      }
      ln = nr;
    }
  }

  /* process_single extension: any-ref candidates until 2 in the list,
   * walking the above row / left col by neighbor widths (mvref.py:646) */
  int refmv_count = s->count;
  int sb_ref = t->sign_bias[ref_frame & 7];
  int mi_width = bw4;
  if (mi_width > t->mi_cols - mi_col) mi_width = t->mi_cols - mi_col;
  int mi_height = bw4;
  if (mi_height > t->mi_rows - mi_row) mi_height = t->mi_rows - mi_row;
  int mi_size = mi_width < mi_height ? mi_width : mi_height;
  for (int axis = 0; axis < 2; axis++) {
    if (axis == 0 ? (max_row_offset > -1) : (max_col_offset > -1)) continue;
    int idx = 0;
    while (idx < mi_size && refmv_count < 2) {
      int gi = axis == 0 ? g_at(t, mi_row - 1, mi_col + idx)
                         : g_at(t, mi_row + idx, mi_col - 1);
      int r0 = t->g_ref[gi];
      if (r0 > 0) {
        int mr = t->g_mvr[gi], mc = t->g_mvc[gi];
        if (t->sign_bias[r0 & 7] != sb_ref) {
          mr = -mr;
          mc = -mc;
        }
        int dup = 0;
        for (int i = 0; i < refmv_count; i++)
          if (s->mvr[i] == mr && s->mvc[i] == mc) {
            dup = 1;
            break;
          }
        if (!dup) {
          s->mvr[refmv_count] = (int16_t)mr;
          s->mvc[refmv_count] = (int16_t)mc;
          s->w[refmv_count] = 2;
          refmv_count++;
        }
      }
      idx += nb_w4(t, gi);
    }
  }
  s->count = refmv_count;
  for (int i = 0; i < refmv_count; i++) {
    int r = s->mvr[i], c0 = s->mvc[i];
    clamp_ref_mv(t, mi_row, mi_col, bw4, &r, &c0);
    s->mvr[i] = (int16_t)r;
    s->mvc[i] = (int16_t)c0;
  }
  *nearest_r = refmv_count > 0 ? s->mvr[0] : 0;
  *nearest_c = refmv_count > 0 ? s->mvc[0] : 0;
  *near_r = refmv_count > 1 ? s->mvr[1] : 0;
  *near_c = refmv_count > 1 ? s->mvc[1] : 0;
  lower_prec(allow_hp, nearest_r, nearest_c);
  lower_prec(allow_hp, near_r, near_c);
  return mode_context;
}

/* ---- MV coding (encodemv.c write mirror) ----------------------------- */

static void write_mv_component(IT *t, int d, int comp, int usehp) {
  const int32_t *o = t->o + 12 + 9 * comp;
  int sign = d < 0;
  int z = (d < 0 ? -d : d) - 1;
  int cls, offset;
  if (z < 16) {
    cls = 0;
    offset = z;
  } else {
    int v = z >> 3, b = 0;
    while (v > 1) {
      v >>= 1;
      b++;
    }
    cls = b > 10 ? 10 : b;
    offset = z - (2 << (cls + 2));
  }
  enc_symbol(&t->e, t->arena + o[0], sign, 2, 1);
  enc_symbol(&t->e, t->arena + o[1], cls, 11, 1);
  int intd = offset >> 3;
  int fr = (offset >> 1) & 3;
  int hp = offset & 1;
  if (cls == 0)
    enc_symbol(&t->e, t->arena + o[2], intd, 2, 1);
  else
    for (int i = 0; i < cls; i++)
      enc_symbol(&t->e, t->arena + o[3] + i * 3, (intd >> i) & 1, 2, 1);
  if (cls == 0)
    enc_symbol(&t->e, t->arena + o[4] + intd * 5, fr, 4, 1);
  else
    enc_symbol(&t->e, t->arena + o[5], fr, 4, 1);
  if (usehp) enc_symbol(&t->e, t->arena + (cls == 0 ? o[6] : o[7]), hp, 2, 1);
}

static void write_mv(IT *t, int mvr, int mvc, int refr, int refc,
                     int allow_hp) {
  int dr = mvr - refr, dc = mvc - refc;
  int joint = (dc ? 1 : 0) | (dr ? 2 : 0);
  enc_symbol(&t->e, t->arena + t->o[11], joint, 4, 1);
  if (dr) write_mv_component(t, dr, 0, allow_hp);
  if (dc) write_mv_component(t, dc, 1, allow_hp);
}

/* ---- per-block emit --------------------------------------------------- */

static int vote3(int a, int b) { return a == b ? 1 : (a < b ? 0 : 2); }

static void it_encode_block(IT *t, int mi_row, int mi_col, int bw4) {
  const int16_t *row;
  int n_y, n_c; /* luma / chroma coefficient counts in the raster row */
  if (bw4 == 4) {
    row = t->res + (size_t)((mi_row >> 2) * t->nbx + (mi_col >> 2)) * 390;
    n_y = 256;
    n_c = 64;
  } else if (bw4 == 8) {
    row = t->res32 +
          (size_t)((mi_row >> 3) * t->nbx2 + (mi_col >> 3)) * 1542;
    n_y = 1024;
    n_c = 256;
  } else {
    row = t->res64 +
          (size_t)((mi_row >> 4) * t->nbx4 + (mi_col >> 4)) * 3078;
    n_y = 1024;
    n_c = 1024;
  }
  int mvr = row[0], mvc = row[1];
  int ref = t->ref_lut[row[2]];
  int eob_y = row[3], eob_u = row[4], eob_v = row[5];
  int skip = (eob_y == 0 && eob_u == 0 && eob_v == 0);
  int up = mi_row > 0, left = mi_col > 0;
  int allow_hp = t->o[33];

  /* skip_txfm */
  int skip_ctx =
      (up ? t->mi_skip[(mi_row - 1) * t->mi_cols + mi_col] : 0) +
      (left ? t->mi_skip[mi_row * t->mi_cols + mi_col - 1] : 0);
  enc_symbol(&t->e, t->arena + t->o[2] + skip_ctx * 3, skip, 2, 1);

  /* intra_inter (pred_common.c:124; all coded neighbors are inter) */
  int ii_ctx;
  if (up && left) {
    int a = t->g_ref[g_at(t, mi_row - 1, mi_col)] <= 0;
    int l = t->g_ref[g_at(t, mi_row, mi_col - 1)] <= 0;
    ii_ctx = (a && l) ? 3 : (a || l);
  } else if (up || left) {
    int gi = up ? g_at(t, mi_row - 1, mi_col) : g_at(t, mi_row, mi_col - 1);
    ii_ctx = 2 * (t->g_ref[gi] <= 0);
  } else {
    ii_ctx = 0;
  }
  enc_symbol(&t->e, t->arena + t->o[3] + ii_ctx * 3, 1, 2, 1);

  /* single_ref tree (ref in {LAST=1..ALTREF=7}) */
  int counts[8] = {0};
  if (up) {
    int r0 = t->g_ref[g_at(t, mi_row - 1, mi_col)];
    if (r0 > 0) counts[r0 & 7]++;
  }
  if (left) {
    int r0 = t->g_ref[g_at(t, mi_row, mi_col - 1)];
    if (r0 > 0) counts[r0 & 7]++;
  }
  int fwd = counts[1] + counts[2] + counts[3] + counts[4];
  int bwd = counts[5] + counts[6] + counts[7];
  {
    int base = t->o[4], s0 = t->o[5], s1 = t->o[6];
    int p1 = vote3(fwd, bwd);
    if (ref <= 4) { /* GOLDEN or lower */
      enc_symbol(&t->e, t->arena + base + p1 * s0 + 0 * s1, 0, 2, 1);
      int p3 = vote3(counts[1] + counts[2], counts[3] + counts[4]);
      if (ref <= 2) {
        enc_symbol(&t->e, t->arena + base + p3 * s0 + 2 * s1, 0, 2, 1);
        int p4 = vote3(counts[1], counts[2]);
        enc_symbol(&t->e, t->arena + base + p4 * s0 + 3 * s1, ref == 2, 2,
                   1);
      } else {
        enc_symbol(&t->e, t->arena + base + p3 * s0 + 2 * s1, 1, 2, 1);
        int p5 = vote3(counts[3], counts[4]);
        enc_symbol(&t->e, t->arena + base + p5 * s0 + 4 * s1, ref == 4, 2,
                   1);
      }
    } else {
      enc_symbol(&t->e, t->arena + base + p1 * s0 + 0 * s1, 1, 2, 1);
      int p2 = vote3(counts[5] + counts[6], counts[7]);
      if (ref == 7) {
        enc_symbol(&t->e, t->arena + base + p2 * s0 + 1 * s1, 1, 2, 1);
      } else {
        enc_symbol(&t->e, t->arena + base + p2 * s0 + 1 * s1, 0, 2, 1);
        int p6 = vote3(counts[5], counts[6]);
        enc_symbol(&t->e, t->arena + base + p6 * s0 + 5 * s1, ref == 6, 2,
                   1);
      }
    }
  }

  /* mv stack + mode */
  Stack s;
  int nearest_r, nearest_c, near_r, near_c;
  int mode_ctx = find_mv_refs(t, mi_row, mi_col, bw4, ref, &s, &nearest_r,
                              &nearest_c, &near_r, &near_c, allow_hp);
  int mode;
  if (mvr == nearest_r && mvc == nearest_c)
    mode = IT_NEARESTMV;
  else if (mvr == near_r && mvc == near_c)
    mode = IT_NEARMV;
  else if (mvr == 0 && mvc == 0)
    mode = IT_GLOBALMV;
  else
    mode = IT_NEWMV;

  int newmv_ctx = mode_ctx & 7;
  enc_symbol(&t->e, t->arena + t->o[7] + newmv_ctx * 3, mode != IT_NEWMV, 2,
             1);
  if (mode != IT_NEWMV) {
    int zeromv_ctx = (mode_ctx >> 3) & 1;
    enc_symbol(&t->e, t->arena + t->o[8] + zeromv_ctx * 3,
               mode != IT_GLOBALMV, 2, 1);
    if (mode != IT_GLOBALMV) {
      int refmv_ctx = (mode_ctx >> 4) & 15;
      enc_symbol(&t->e, t->arena + t->o[9] + refmv_ctx * 3,
                 mode != IT_NEARESTMV, 2, 1);
    }
  }
  /* drl (ref_mv_idx always 0) */
  if (mode == IT_NEWMV) {
    for (int idx = 0; idx < 2; idx++) {
      if (s.count > idx + 1) {
        int dctx =
            (s.w[idx] >= REF_CAT_LEVEL && s.w[idx + 1] >= REF_CAT_LEVEL)
                ? 0
                : (s.w[idx] >= REF_CAT_LEVEL && s.w[idx + 1] < REF_CAT_LEVEL
                       ? 1
                       : (s.w[idx] < REF_CAT_LEVEL &&
                                  s.w[idx + 1] < REF_CAT_LEVEL
                              ? 2
                              : 0));
        enc_symbol(&t->e, t->arena + t->o[10] + dctx * 3, 0, 2, 1);
        break;
      }
    }
  } else if (mode == IT_NEARMV) {
    for (int idx = 1; idx < 3; idx++) {
      if (s.count > idx + 1) {
        int dctx =
            (s.w[idx] >= REF_CAT_LEVEL && s.w[idx + 1] >= REF_CAT_LEVEL)
                ? 0
                : (s.w[idx] >= REF_CAT_LEVEL && s.w[idx + 1] < REF_CAT_LEVEL
                       ? 1
                       : (s.w[idx] < REF_CAT_LEVEL &&
                                  s.w[idx + 1] < REF_CAT_LEVEL
                              ? 2
                              : 0));
        enc_symbol(&t->e, t->arena + t->o[10] + dctx * 3, 0, 2, 1);
        break;
      }
    }
  }
  if (mode == IT_NEWMV) {
    int refr = nearest_r, refc = nearest_c;
    if (s.count > 1) {
      refr = s.mvr[0];
      refc = s.mvc[0];
    }
    write_mv(t, mvr, mvc, refr, refc, allow_hp);
  }

  /* mi bookkeeping */
  for (int r = mi_row; r < mi_row + bw4; r++) {
    memset(t->mi_skip + r * t->mi_cols + mi_col, skip, (size_t)bw4);
    int gi = g_at(t, r, mi_col);
    for (int c0 = 0; c0 < bw4; c0++) {
      t->g_ref[gi + c0] = (int8_t)ref;
      t->g_mode[gi + c0] = (uint8_t)mode;
      t->g_mvr[gi + c0] = (int16_t)mvr;
      t->g_mvc[gi + c0] = (int16_t)mvc;
      t->g_bw4[gi + c0] = (uint8_t)bw4;
    }
  }

  /* residual geometry per leaf level: luma tx == block (TX_16X16 /
   * TX_32X32 / TX_64X64), chroma tx == half (TX_8X8 / TX_16X16 /
   * TX_32X32).  TX_64X64 codes the adjusted 32x32 coefficient domain
   * (same dims/scan as TX_32X32) through its own cdfset row. */
  int acol = mi_col, lrow = mi_row;
  int cacol = mi_col >> 1, clrow = mi_row >> 1;
  int cw4 = bw4 >> 1; /* chroma width in 4px entropy units */
  if (skip) {
    memset(t->ae[0] + acol, 0, (size_t)bw4);
    memset(t->le[0] + lrow, 0, (size_t)bw4);
    for (int p = 1; p < 3; p++) {
      memset(t->ae[p] + cacol, 0, (size_t)cw4);
      memset(t->le[p] + clrow, 0, (size_t)cw4);
    }
    return;
  }
  const int32_t *cs_y, *cs_c;
  const int16_t *scan_y, *scan_c;
  int wy, bhly, msy, wc, bhlc, msc, tt_off, tt_n, tt_sym;
  if (bw4 == 4) {
    cs_y = t->cdfsets;
    cs_c = t->cdfsets + 8;
    scan_y = t->scan16;
    scan_c = t->scan8;
    wy = 16;
    bhly = 4;
    msy = 4;
    wc = 8;
    bhlc = 3;
    msc = 2;
    tt_off = t->o[30];
    tt_n = t->o[31];
    tt_sym = t->o[32];
  } else if (bw4 == 8) {
    cs_y = t->cdfsets + 16;
    cs_c = t->cdfsets + 24;
    scan_y = t->scan32;
    scan_c = t->scan16;
    wy = 32;
    bhly = 5;
    msy = 6;
    wc = 16;
    bhlc = 4;
    msc = 4;
    /* inter 32x32 ext-tx set is DCT_IDTX (2 symbols) */
    tt_off = t->o[34];
    tt_n = t->o[35];
    tt_sym = t->o[36];
  } else {
    cs_y = t->cdfsets + 32;
    cs_c = t->cdfsets + 40;
    scan_y = t->scan32;
    scan_c = t->scan32;
    wy = 32; /* adjusted TX_64X64 domain */
    bhly = 5;
    msy = 6;
    wc = 32;
    bhlc = 5;
    msc = 6;
    tt_off = -1; /* 64-dim: DCTONLY, no symbol */
    tt_n = 0;
    tt_sym = 0;
  }
  /* luma txb: plane_bsize == tx_bsize -> skip_ctx 0 */
  {
    const int16_t *q16 = row + 6;
    for (int i = 0; i < n_y; i++) t->q32[i] = q16[i];
    uint8_t *au = t->ae[0], *lu = t->le[0];
    int ds = 0;
    for (int i = 0; i < bw4; i++) ds += dc_sign_of(au[acol + i]);
    for (int i = 0; i < bw4; i++) ds += dc_sign_of(lu[lrow + i]);
    int dc_sign_ctx = ds == 0 ? 0 : (ds < 0 ? 1 : 2);
    int cul = code_txb(&t->e, t->arena, cs_y, t->q32, scan_y, wy, wy,
                       bhly, 0, wy, wy, msy, 0, dc_sign_ctx, tt_off,
                       tt_n, tt_sym, t->levels);
    memset(au + acol, cul, (size_t)bw4);
    memset(lu + lrow, cul, (size_t)bw4);
  }
  for (int p = 1; p < 3; p++) {
    const int16_t *q16 = row + 6 + n_y + (p - 1) * n_c;
    for (int i = 0; i < n_c; i++) t->q32[i] = q16[i];
    uint8_t *au = t->ae[p], *lu = t->le[p];
    int ds = 0;
    for (int i = 0; i < cw4; i++) ds += dc_sign_of(au[cacol + i]);
    for (int i = 0; i < cw4; i++) ds += dc_sign_of(lu[clrow + i]);
    int dc_sign_ctx = ds == 0 ? 0 : (ds < 0 ? 1 : 2);
    int a = 0, l = 0;
    for (int i = 0; i < cw4; i++) a |= au[cacol + i] != 0;
    for (int i = 0; i < cw4; i++) l |= lu[clrow + i] != 0;
    int skip_ctx2 = a + l + 7; /* plane_bsize == tx bsize */
    int cul = code_txb(&t->e, t->arena, cs_c, t->q32, scan_c, wc, wc,
                       bhlc, 0, wc, wc, msc, skip_ctx2, dc_sign_ctx, -1,
                       0, 0, t->levels);
    memset(au + cacol, cul, (size_t)cw4);
    memset(lu + clrow, cul, (size_t)cw4);
  }
}

/* ---- partition walk (forced split to 16x16) --------------------------- */

static void it_write_partition(IT *t, int mi_row, int mi_col, int bsize_w4,
                               int partition) {
  int hbs = bsize_w4 / 2;
  int has_rows = mi_row + hbs < t->mi_rows;
  int has_cols = mi_col + hbs < t->mi_cols;
  if (!has_rows && !has_cols) return;
  int bsl = 0, v = bsize_w4;
  while (v > 2) {
    v >>= 1;
    bsl++;
  }
  int above = (t->above_part[mi_col] >> bsl) & 1;
  int leftb = (t->left_part[mi_row] >> bsl) & 1;
  int ctx = (leftb * 2 + above) + bsl * 4;
  uint16_t *cdf = t->arena + t->o[0] + ctx * t->o[1];
  if (has_rows && has_cols)
    enc_symbol(&t->e, cdf, partition, 10, 1);
  else
    enc_gather_split(&t->e, cdf, 0, !has_cols, partition == 3);
}

static void it_update_ext_ctx(IT *t, int mi_row, int mi_col, int sub_w4,
                              int bsize_w4, int partition) {
  if (partition == 3 /* SPLIT */ && bsize_w4 != 2) return;
  int l2w = 0, v = sub_w4;
  while (v > 1) {
    v >>= 1;
    l2w++;
  }
  uint8_t mark = (uint8_t)((31 << l2w) & 31);
  memset(t->above_part + mi_col, mark, (size_t)bsize_w4);
  memset(t->left_part + mi_row, mark, (size_t)bsize_w4);
}

static void it_encode_partition(IT *t, int mi_row, int mi_col,
                                int bsize_w4) {
  if (mi_row >= t->mi_rows || mi_col >= t->mi_cols) return;
  int hbs = bsize_w4 / 2;
  int partition = bsize_w4 == 4 ? 0 /* NONE */ : 3 /* SPLIT */;
  /* variable partitions: the device DP's lvl map picks merged leaves
   * (1 = 32x32 at bsize_w4 8, 2 = 64x64 at bsize_w4 16) for blocks
   * fully inside the frame */
  if (t->lvl != NULL && partition == 3 && bsize_w4 <= 16 &&
      mi_row + bsize_w4 <= t->mi_rows && mi_col + bsize_w4 <= t->mi_cols) {
    int want = bsize_w4 == 16 ? 2 : 1;
    if (t->lvl[(mi_row >> 2) * t->nbx + (mi_col >> 2)] == want)
      partition = 0;
  }
  it_write_partition(t, mi_row, mi_col, bsize_w4, partition);
  int sub_w4 = partition == 0 ? bsize_w4 : hbs;
  if (partition == 0) {
    it_encode_block(t, mi_row, mi_col, bsize_w4);
  } else {
    it_encode_partition(t, mi_row, mi_col, hbs);
    it_encode_partition(t, mi_row, mi_col + hbs, hbs);
    it_encode_partition(t, mi_row + hbs, mi_col, hbs);
    it_encode_partition(t, mi_row + hbs, mi_col + hbs, hbs);
  }
  it_update_ext_ctx(t, mi_row, mi_col, sub_w4, bsize_w4, partition);
}

/* ---- uniform-16x16 KEY-frame (intra) tile ------------------------------
 *
 * Walker for the wavefront all-intra device path (ops/wavefront.py +
 * encoder/tpu_intra.py): forced-split partitions, skip, kf y mode with
 * neighbour-mode contexts, angle-delta(0) for directional modes, DC
 * chroma, intra tx-type symbol, coeff txbs.  Mirrors the Python emitter
 * (encoder/lossy.py _emit_block KEY path) byte-exactly.
 *
 * ioffs layout: 0 partition_base 1 partition_stride 2 skip_base
 *   3 kf_y_base (5x5 grid of rows of 14)  4 angle_base (rows of 8)
 *   5 uv_base (uv_mode_cdf[1][mode], rows of 15)
 *   6 txtype_base (+ y_mode * 17)  7 txtype_nsymbs  8 txtype_sym
 */

/* av1 intra_mode_context (reused for both axes of kf_y_cdf) */
static const uint8_t IMC[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};

typedef struct {
  int mi_rows, mi_cols, sb_mi;
  const int16_t *res;
  int nbx;
  uint16_t *arena;
  const int32_t *o;
  const int32_t *cdfsets;
  const int16_t *scan16, *scan8;
  uint8_t *above_part, *left_part;
  uint8_t *ae[3], *le[3];
  uint8_t *mi_skip;
  uint8_t *g_mode; /* margin grid of y modes (DC default) */
  int gw;
  RangeEnc e;
  int16_t levels[32 * 36];
  int32_t q32[256];
} ITK;

static void itk_encode_block(ITK *t, int mi_row, int mi_col) {
  int b = (mi_row >> 2) * t->nbx + (mi_col >> 2);
  const int16_t *row = t->res + (size_t)b * 390;
  int y_mode = row[0];
  int eob_y = row[1], eob_u = row[2], eob_v = row[3];
  int skip = (eob_y == 0 && eob_u == 0 && eob_v == 0);
  int up = mi_row > 0, left = mi_col > 0;

  int skip_ctx =
      (up ? t->mi_skip[(mi_row - 1) * t->mi_cols + mi_col] : 0) +
      (left ? t->mi_skip[mi_row * t->mi_cols + mi_col - 1] : 0);
  enc_symbol(&t->e, t->arena + t->o[2] + skip_ctx * 3, skip, 2, 1);

  int am = up ? t->g_mode[(mi_row - 1 + MI_M) * t->gw + mi_col + MI_M] : 0;
  int lm = left ? t->g_mode[(mi_row + MI_M) * t->gw + mi_col - 1 + MI_M]
                : 0;
  enc_symbol(&t->e,
             t->arena + t->o[3] + (IMC[am] * 5 + IMC[lm]) * 14, y_mode,
             13, 1);
  if (y_mode >= 1 && y_mode <= 8) /* directional: angle delta 0 */
    enc_symbol(&t->e, t->arena + t->o[4] + (y_mode - 1) * 8, 3, 7, 1);
  /* chroma: DC, CfL allowed at 16x16 -> 14 symbols */
  enc_symbol(&t->e, t->arena + t->o[5] + y_mode * 15, 0, 14, 1);

  for (int r = mi_row; r < mi_row + 4; r++) {
    memset(t->mi_skip + r * t->mi_cols + mi_col, skip, 4);
    memset(t->g_mode + (r + MI_M) * t->gw + mi_col + MI_M,
           (uint8_t)y_mode, 4);
  }

  int acol = mi_col, lrow = mi_row;
  int cacol = mi_col >> 1, clrow = mi_row >> 1;
  if (skip) {
    memset(t->ae[0] + acol, 0, 4);
    memset(t->le[0] + lrow, 0, 4);
    for (int p = 1; p < 3; p++) {
      memset(t->ae[p] + cacol, 0, 2);
      memset(t->le[p] + clrow, 0, 2);
    }
    return;
  }
  {
    const int16_t *q16 = row + 6;
    for (int i = 0; i < 256; i++) t->q32[i] = q16[i];
    uint8_t *au = t->ae[0], *lu = t->le[0];
    int ds = 0;
    for (int i = 0; i < 4; i++) ds += dc_sign_of(au[acol + i]);
    for (int i = 0; i < 4; i++) ds += dc_sign_of(lu[lrow + i]);
    int dc_sign_ctx = ds == 0 ? 0 : (ds < 0 ? 1 : 2);
    int cul = code_txb(&t->e, t->arena, t->cdfsets, t->q32, t->scan16, 16,
                       16, 4, 0, 16, 16, 4, 0, dc_sign_ctx,
                       t->o[6] + y_mode * 17, t->o[7], t->o[8],
                       t->levels);
    memset(au + acol, cul, 4);
    memset(lu + lrow, cul, 4);
  }
  for (int p = 1; p < 3; p++) {
    const int16_t *q16 = row + 262 + (p - 1) * 64;
    for (int i = 0; i < 64; i++) t->q32[i] = q16[i];
    uint8_t *au = t->ae[p], *lu = t->le[p];
    int ds = 0;
    for (int i = 0; i < 2; i++) ds += dc_sign_of(au[cacol + i]);
    for (int i = 0; i < 2; i++) ds += dc_sign_of(lu[clrow + i]);
    int dc_sign_ctx = ds == 0 ? 0 : (ds < 0 ? 1 : 2);
    int a = 0, l = 0;
    for (int i = 0; i < 2; i++) a |= au[cacol + i] != 0;
    for (int i = 0; i < 2; i++) l |= lu[clrow + i] != 0;
    int skip_ctx2 = a + l + 7;
    int cul = code_txb(&t->e, t->arena, t->cdfsets + 8, t->q32, t->scan8, 8,
                       8, 3, 0, 8, 8, 2, skip_ctx2, dc_sign_ctx, -1, 0, 0,
                       t->levels);
    memset(au + cacol, cul, 2);
    memset(lu + clrow, cul, 2);
  }
}

static void itk_write_partition(ITK *t, int mi_row, int mi_col,
                                int bsize_w4, int partition) {
  int hbs = bsize_w4 / 2;
  int has_rows = mi_row + hbs < t->mi_rows;
  int has_cols = mi_col + hbs < t->mi_cols;
  if (!has_rows && !has_cols) return;
  int bsl = 0, v = bsize_w4;
  while (v > 2) {
    v >>= 1;
    bsl++;
  }
  int above = (t->above_part[mi_col] >> bsl) & 1;
  int leftb = (t->left_part[mi_row] >> bsl) & 1;
  int ctx = (leftb * 2 + above) + bsl * 4;
  uint16_t *cdf = t->arena + t->o[0] + ctx * t->o[1];
  if (has_rows && has_cols)
    enc_symbol(&t->e, cdf, partition, 10, 1);
  else
    enc_gather_split(&t->e, cdf, 0, !has_cols, partition == 3);
}

static void itk_encode_partition(ITK *t, int mi_row, int mi_col,
                                 int bsize_w4) {
  if (mi_row >= t->mi_rows || mi_col >= t->mi_cols) return;
  int hbs = bsize_w4 / 2;
  int partition = bsize_w4 == 4 ? 0 : 3;
  itk_write_partition(t, mi_row, mi_col, bsize_w4, partition);
  int sub_w4 = partition == 0 ? bsize_w4 : hbs;
  if (partition == 0) {
    itk_encode_block(t, mi_row, mi_col);
  } else {
    itk_encode_partition(t, mi_row, mi_col, hbs);
    itk_encode_partition(t, mi_row, mi_col + hbs, hbs);
    itk_encode_partition(t, mi_row + hbs, mi_col, hbs);
    itk_encode_partition(t, mi_row + hbs, mi_col + hbs, hbs);
  }
  if (!(partition == 3 && bsize_w4 != 2)) {
    int l2w = 0, v = sub_w4;
    while (v > 1) {
      v >>= 1;
      l2w++;
    }
    uint8_t mark = (uint8_t)((31 << l2w) & 31);
    memset(t->above_part + mi_col, mark, (size_t)bsize_w4);
    memset(t->left_part + mi_row, mark, (size_t)bsize_w4);
  }
}

int avl_encode_intra16_tile(const int16_t *res, int mi_rows, int mi_cols,
                            int sb_mi, uint16_t *arena,
                            const int32_t *ioffs, const int32_t *cdfsets,
                            const int16_t *scan16, const int16_t *scan8,
                            uint8_t *out, int out_cap) {
  ITK t;
  memset(&t, 0, sizeof(t));
  t.mi_rows = mi_rows;
  t.mi_cols = mi_cols;
  t.sb_mi = sb_mi;
  t.res = res;
  t.nbx = mi_cols / 4;
  t.arena = arena;
  t.o = ioffs;
  t.cdfsets = cdfsets;
  t.scan16 = scan16;
  t.scan8 = scan8;
  t.gw = mi_cols + 2 * MI_M;
  size_t apn = (size_t)mi_cols + 32, lpn = (size_t)mi_rows + 32;
  size_t gn = (size_t)(mi_rows + 2 * MI_M) * t.gw;
  uint8_t *mem = (uint8_t *)calloc(
      apn + lpn + 3 * (apn + lpn) + (size_t)mi_rows * mi_cols + gn, 1);
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
  p += (size_t)mi_rows * mi_cols;
  t.g_mode = p;
  re_init(&t.e, out, (size_t)out_cap);
  for (int mi_row = 0; mi_row < mi_rows; mi_row += sb_mi) {
    memset(t.left_part, 0, lpn);
    for (int i = 0; i < 3; i++) memset(t.le[i], 0, lpn);
    for (int mi_col = 0; mi_col < mi_cols; mi_col += sb_mi)
      itk_encode_partition(&t, mi_row, mi_col, sb_mi);
  }
  int n = (int)re_done(&t.e);
  free(mem);
  return n;
}

/* Encode one inter tile with square {16,32,64} leaves.  res: (B, 390)
 * int16 packed 16x16 results (ops/inter_tpu.py layout); lvl/res32/res64:
 * the variable-partition extension (lvl NULL = uniform 16x16); ref_lut
 * maps device ref_idx to AV1 ref frames; offs per the table above.
 * cdfsets: 6 rows of 8 (see IT).  Returns byte length. */
int avl_encode_inter_tile(const int16_t *res, const uint8_t *lvl,
                          const int16_t *res32, const int16_t *res64,
                          int mi_rows, int mi_cols, int sb_mi, int ref0,
                          int ref1, const int8_t *sign_bias,
                          uint16_t *arena, const int32_t *offs,
                          const int32_t *cdfsets, const int16_t *scan16,
                          const int16_t *scan8, const int16_t *scan32,
                          uint8_t *out, int out_cap) {
  IT t;
  memset(&t, 0, sizeof(t));
  t.mi_rows = mi_rows;
  t.mi_cols = mi_cols;
  t.sb_mi = sb_mi;
  t.res = res;
  t.nbx = mi_cols / 4;
  t.nbx2 = t.nbx / 2;
  t.nbx4 = t.nbx / 4;
  t.lvl = lvl;
  t.res32 = res32;
  t.res64 = res64;
  t.scan32 = scan32;
  t.ref_lut[0] = ref0;
  t.ref_lut[1] = ref1;
  t.sign_bias = sign_bias;
  t.arena = arena;
  t.o = offs;
  t.cdfsets = cdfsets;
  t.scan16 = scan16;
  t.scan8 = scan8;
  t.gw = mi_cols + 2 * MI_M;
  size_t apn = (size_t)mi_cols + 32, lpn = (size_t)mi_rows + 32;
  size_t gn = (size_t)(mi_rows + 2 * MI_M) * t.gw;
  uint8_t *mem = (uint8_t *)calloc(
      apn + lpn + 3 * (apn + lpn) + (size_t)mi_rows * mi_cols + gn * 3 +
          gn * 4 + 64,
      1);
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
  p += (size_t)mi_rows * mi_cols;
  t.g_ref = (int8_t *)p;
  p += gn;
  t.g_mode = (uint8_t *)p;
  p += gn;
  t.g_bw4 = (uint8_t *)p;
  p += gn;
  p = (uint8_t *)(((uintptr_t)p + 1) & ~(uintptr_t)1);
  t.g_mvr = (int16_t *)p;
  p += gn * 2;
  t.g_mvc = (int16_t *)p;
  re_init(&t.e, out, (size_t)out_cap);
  for (int mi_row = 0; mi_row < mi_rows; mi_row += sb_mi) {
    memset(t.left_part, 0, lpn);
    for (int i = 0; i < 3; i++) memset(t.le[i], 0, lpn);
    for (int mi_col = 0; mi_col < mi_cols; mi_col += sb_mi)
      it_encode_partition(&t, mi_row, mi_col, sb_mi);
  }
  int n = (int)re_done(&t.e);
  free(mem);
  return n;
}

/* Back-compat entry: uniform 16x16 (lvl = NULL). */
int avl_encode_inter16_tile(const int16_t *res, int mi_rows, int mi_cols,
                            int sb_mi, int ref0, int ref1,
                            const int8_t *sign_bias, uint16_t *arena,
                            const int32_t *offs, const int32_t *cdfsets,
                            const int16_t *scan16, const int16_t *scan8,
                            uint8_t *out, int out_cap) {
  return avl_encode_inter_tile(res, NULL, NULL, NULL, mi_rows, mi_cols,
                               sb_mi, ref0, ref1, sign_bias, arena, offs,
                               cdfsets, scan16, scan8, NULL, out, out_cap);
}
