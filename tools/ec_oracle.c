/* Thin C wrapper exposing the *reference* range coder (linked from the
 * read-only reference checkout) as a shared library for byte-exact
 * cross-checking of our implementation in tests.
 * This file is test scaffolding only; it is not part of the framework. */
#include <stdint.h>
#include <string.h>
#include "aom_dsp/entenc.h"
#include "aom_dsp/entdec.h"
#include "aom_dsp/prob.h"

/* Encode a sequence of symbols; kinds[i]: 0 = cdf symbol (adaptive if
 * adapt[i]), 1 = literal bit.  cdfs is a [n][18] table of icdf values
 * (slot 17 unused).  Returns number of output bytes. */
int ec_oracle_encode(const int32_t *kinds, const int32_t *syms,
                     const int32_t *nsymbs, const int32_t *adapt,
                     uint16_t *cdfs, int n, unsigned char *out, int out_cap) {
  od_ec_enc enc;
  od_ec_enc_init(&enc, 1024);
  for (int i = 0; i < n; i++) {
    uint16_t *cdf = cdfs + 18 * i;
    if (kinds[i] == 0) {
      od_ec_encode_cdf_q15(&enc, syms[i], cdf, nsymbs[i]);
      if (adapt[i]) update_cdf(cdf, (int8_t)syms[i], nsymbs[i]);
    } else {
      int p = (0x7FFFFF - (128 << 15) + 128) >> 8;
      od_ec_encode_bool_q15(&enc, syms[i], p);
    }
  }
  uint32_t nbytes = 0;
  unsigned char *buf = od_ec_enc_done(&enc, &nbytes);
  if (!buf || (int)nbytes > out_cap) {
    od_ec_enc_clear(&enc);
    return -1;
  }
  memcpy(out, buf, nbytes);
  od_ec_enc_clear(&enc);
  return (int)nbytes;
}

int ec_oracle_decode(const unsigned char *data, int nbytes,
                     const int32_t *kinds, const int32_t *nsymbs,
                     const int32_t *adapt, uint16_t *cdfs, int n,
                     int32_t *out_syms) {
  od_ec_dec dec;
  od_ec_dec_init(&dec, data, (uint32_t)nbytes);
  for (int i = 0; i < n; i++) {
    uint16_t *cdf = cdfs + 18 * i;
    if (kinds[i] == 0) {
      int s = od_ec_decode_cdf_q15(&dec, cdf, nsymbs[i]);
      if (adapt[i]) update_cdf(cdf, (int8_t)s, nsymbs[i]);
      out_syms[i] = s;
    } else {
      int p = (0x7FFFFF - (128 << 15) + 128) >> 8;
      out_syms[i] = od_ec_decode_bool_q15(&dec, p);
    }
  }
  return 0;
}
