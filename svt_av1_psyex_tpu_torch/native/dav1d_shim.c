/*
 * dav1d_shim.c — minimal conformance-decode harness around libdav1d.
 *
 * Decodes an IVF file with the system libdav1d and dumps every output
 * frame's planes to a raw file, so the Python test harness can compare
 * dav1d's reconstruction bit-exactly against the encoder's own recon
 * (the same oracle pattern as the reference's e2e tests, which use a
 * vendored libaom decoder: test/e2e_test/RefDecoder.h).
 *
 * API declarations below are written against the public, ABI-stable
 * dav1d 1.x API (soname 6). Structs whose exact tail layout may vary
 * across minor versions (Dav1dPicture, Dav1dSettings, Dav1dData) are
 * over-allocated and only their leading, ABI-frozen fields are accessed.
 *
 * Build: gcc -O2 -shared -fPIC dav1d_shim.c -o libdav1dshim.so -ldav1d
 * Also usable standalone: gcc -O2 -DSHIM_MAIN dav1d_shim.c -o dav1d_decode -ldav1d
 *
 * Output format (little endian):
 *   per frame: u32 0x46524D45 ("EMRF"), u32 w, u32 h, u32 layout(0=400,
 *   1=420,2=422,3=444), u32 bpc, then per plane: u32 rows, u32 cols,
 *   rows*cols*(bpc>8?2:1) bytes, row-major, no padding.
 */

#include <errno.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ---- minimal dav1d 1.x public API declarations ---- */

typedef struct Dav1dContext Dav1dContext;
typedef struct Dav1dRef Dav1dRef;

typedef struct {
    const uint8_t *data;
    Dav1dRef *ref;
} Dav1dUserData;

typedef struct {
    int64_t timestamp;
    int64_t duration;
    int64_t offset;
    size_t size;
    Dav1dUserData user_data;
} Dav1dDataProps;

typedef struct {
    const uint8_t *data;
    size_t sz;
    Dav1dRef *ref;
    Dav1dDataProps m;
    uint8_t pad[64]; /* safety against minor-version growth */
} Dav1dData;

typedef struct {
    int w, h;
    int layout; /* enum Dav1dPixelLayout */
    int bpc;
} Dav1dPictureParameters;

typedef struct {
    void *seq_hdr;
    void *frame_hdr;
    void *data[3];
    ptrdiff_t stride[2];
    Dav1dPictureParameters p;
    Dav1dDataProps m;
    /* trailing fields (metadata ptrs, refs) vary by minor version: */
    uint8_t pad[256];
} Dav1dPicture;

typedef struct {
    uint8_t opaque[1024]; /* Dav1dSettings is ~64B; over-allocate */
} Dav1dSettingsBuf;

extern void dav1d_default_settings(void *s);
extern int dav1d_open(Dav1dContext **c, const void *s);
extern int dav1d_data_wrap(Dav1dData *d, const uint8_t *buf, size_t sz,
                           void (*free_cb)(const uint8_t *, void *), void *cookie);
extern int dav1d_send_data(Dav1dContext *c, Dav1dData *d);
extern int dav1d_get_picture(Dav1dContext *c, Dav1dPicture *p);
extern void dav1d_picture_unref(Dav1dPicture *p);
extern void dav1d_data_unref(Dav1dData *d);
extern void dav1d_close(Dav1dContext **c);
extern const char *dav1d_version(void);

static void noop_free(const uint8_t *buf, void *cookie) {
    (void)buf;
    (void)cookie;
}

static uint32_t rd_u32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

static void wr_u32(FILE *f, uint32_t v) {
    uint8_t b[4] = {v & 0xff, (v >> 8) & 0xff, (v >> 16) & 0xff, (v >> 24) & 0xff};
    fwrite(b, 1, 4, f);
}

static int dump_picture(Dav1dPicture *pic, FILE *out) {
    int w = pic->p.w, h = pic->p.h, layout = pic->p.layout, bpc = pic->p.bpc;
    int bytes = bpc > 8 ? 2 : 1;
    wr_u32(out, 0x46524D45u);
    wr_u32(out, (uint32_t)w);
    wr_u32(out, (uint32_t)h);
    wr_u32(out, (uint32_t)layout);
    wr_u32(out, (uint32_t)bpc);
    int nplanes = layout == 0 ? 1 : 3;
    for (int pl = 0; pl < nplanes; pl++) {
        int ss_hor = (pl > 0 && (layout == 1 || layout == 2)) ? 1 : 0;
        int ss_ver = (pl > 0 && layout == 1) ? 1 : 0;
        int pw = (w + ss_hor) >> ss_hor;
        int ph = (h + ss_ver) >> ss_ver;
        ptrdiff_t stride = pic->stride[pl > 0 ? 1 : 0];
        const uint8_t *src = (const uint8_t *)pic->data[pl];
        wr_u32(out, (uint32_t)ph);
        wr_u32(out, (uint32_t)pw);
        for (int r = 0; r < ph; r++)
            fwrite(src + (ptrdiff_t)r * stride, 1, (size_t)pw * bytes, out);
    }
    return 0;
}

/* returns number of frames decoded, or negative error */
int shim_decode_ivf(const char *ivf_path, const char *out_path, char *errbuf,
                    int errlen) {
#define FAIL(...)                                   \
    do {                                            \
        if (errbuf) snprintf(errbuf, errlen, __VA_ARGS__); \
        goto cleanup;                               \
    } while (0)

    FILE *in = NULL, *out = NULL;
    uint8_t *filebuf = NULL;
    Dav1dContext *ctx = NULL;
    int nframes = 0;
    int ret = -1;

    in = fopen(ivf_path, "rb");
    if (!in) FAIL("cannot open %s", ivf_path);
    out = fopen(out_path, "wb");
    if (!out) FAIL("cannot open %s", out_path);

    fseek(in, 0, SEEK_END);
    long fsz = ftell(in);
    fseek(in, 0, SEEK_SET);
    filebuf = malloc((size_t)fsz);
    if (!filebuf || fread(filebuf, 1, (size_t)fsz, in) != (size_t)fsz)
        FAIL("read failed");
    if (fsz < 32 || memcmp(filebuf, "DKIF", 4) != 0) FAIL("not IVF");
    uint32_t hdr_sz = filebuf[6] | (filebuf[7] << 8);

    Dav1dSettingsBuf settings;
    memset(&settings, 0, sizeof(settings));
    dav1d_default_settings(&settings);
    int rc = dav1d_open(&ctx, &settings);
    if (rc) FAIL("dav1d_open: %d", rc);

    size_t pos = hdr_sz;
    while (pos + 12 <= (size_t)fsz) {
        uint32_t payload_sz = rd_u32(filebuf + pos);
        pos += 12;
        if (pos + payload_sz > (size_t)fsz) FAIL("truncated frame");

        Dav1dData data;
        memset(&data, 0, sizeof(data));
        rc = dav1d_data_wrap(&data, filebuf + pos, payload_sz, noop_free, NULL);
        if (rc) FAIL("data_wrap: %d", rc);
        pos += payload_sz;

        while (data.sz > 0) {
            rc = dav1d_send_data(ctx, &data);
            if (rc && rc != -EAGAIN) {
                dav1d_data_unref(&data);
                FAIL("send_data: %d", rc);
            }
            /* drain pictures */
            for (;;) {
                Dav1dPicture pic;
                memset(&pic, 0, sizeof(pic));
                int prc = dav1d_get_picture(ctx, &pic);
                if (prc == -EAGAIN) break;
                if (prc) {
                    dav1d_data_unref(&data);
                    FAIL("get_picture: %d", prc);
                }
                dump_picture(&pic, out);
                dav1d_picture_unref(&pic);
                nframes++;
            }
            if (rc == 0 && data.sz == 0) break;
        }
        dav1d_data_unref(&data);
    }

    /* flush */
    for (;;) {
        Dav1dPicture pic;
        memset(&pic, 0, sizeof(pic));
        int prc = dav1d_get_picture(ctx, &pic);
        if (prc) break;
        dump_picture(&pic, out);
        dav1d_picture_unref(&pic);
        nframes++;
    }

    ret = nframes;
cleanup:
    if (ctx) dav1d_close(&ctx);
    if (filebuf) free(filebuf);
    if (in) fclose(in);
    if (out) fclose(out);
    return ret;
#undef FAIL
}

const char *shim_dav1d_version(void) { return dav1d_version(); }

#ifdef SHIM_MAIN
int main(int argc, char **argv) {
    if (argc != 3) {
        fprintf(stderr, "usage: %s in.ivf out.raw\n", argv[0]);
        return 2;
    }
    char err[256] = {0};
    int n = shim_decode_ivf(argv[1], argv[2], err, sizeof(err));
    if (n < 0) {
        fprintf(stderr, "decode failed: %s\n", err);
        return 1;
    }
    fprintf(stderr, "dav1d %s decoded %d frames\n", dav1d_version(), n);
    return 0;
}
#endif
