// Native PNG scanline unfiltering — the hot loop of PNG decode.
//
// The reference framework leans on OpenCV (C++) for all image I/O
// (/root/reference/serial.cpp:22); this framework's runtime is
// OpenCV-free, with a pure-Python codec (utils/imageio.py) and this C++
// fast path for the sequential, branch-heavy per-scanline unfilter that
// Python executes ~1000x slower. Loaded via ctypes (no pybind11 in the
// image); falls back to Python transparently when the .so is absent.
//
// Build: make -C fft_restoration_tpu/native
//
// PNG filter spec (RFC 2083 §6): each scanline is prefixed by a filter
// byte 0..4 (None, Sub, Up, Average, Paeth); reconstruction is
// sequential in x for Sub/Average/Paeth and in y for Up/Average/Paeth.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

#include <atomic>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// raw:    height * (stride + 1) filtered bytes (filter byte per row)
// out:    height * stride reconstructed bytes
// return: 0 on success, -1 on a bad filter byte
int unfilter_scanlines(const uint8_t* raw, uint8_t* out, int height,
                       int stride, int bpp) {
    const uint8_t* prev = nullptr;
    for (int y = 0; y < height; ++y) {
        const uint8_t* src = raw + static_cast<int64_t>(y) * (stride + 1);
        uint8_t* dst = out + static_cast<int64_t>(y) * stride;
        const uint8_t filter = src[0];
        ++src;
        switch (filter) {
            case 0:  // None
                std::memcpy(dst, src, stride);
                break;
            case 1:  // Sub
                std::memcpy(dst, src, bpp);
                for (int x = bpp; x < stride; ++x)
                    dst[x] = static_cast<uint8_t>(src[x] + dst[x - bpp]);
                break;
            case 2:  // Up
                if (prev) {
                    for (int x = 0; x < stride; ++x)
                        dst[x] = static_cast<uint8_t>(src[x] + prev[x]);
                } else {
                    std::memcpy(dst, src, stride);
                }
                break;
            case 3:  // Average
                for (int x = 0; x < stride; ++x) {
                    const int left = x >= bpp ? dst[x - bpp] : 0;
                    const int up = prev ? prev[x] : 0;
                    dst[x] = static_cast<uint8_t>(src[x] + ((left + up) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int x = 0; x < stride; ++x) {
                    const int left = x >= bpp ? dst[x - bpp] : 0;
                    const int up = prev ? prev[x] : 0;
                    const int ul = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    dst[x] = static_cast<uint8_t>(src[x] + paeth(left, up, ul));
                }
                break;
            default:
                return -1;
        }
        prev = dst;
    }
    return 0;
}

// Filter scanlines for encoding with the Paeth predictor (type 4) —
// better compression than the Python encoder's Up filter on natural
// images. out must hold height * (stride + 1) bytes.
int filter_scanlines_paeth(const uint8_t* img, uint8_t* out, int height,
                           int stride, int bpp) {
    const uint8_t* prev = nullptr;
    for (int y = 0; y < height; ++y) {
        const uint8_t* src = img + static_cast<int64_t>(y) * stride;
        uint8_t* dst = out + static_cast<int64_t>(y) * (stride + 1);
        dst[0] = 4;
        ++dst;
        for (int x = 0; x < stride; ++x) {
            const int left = x >= bpp ? src[x - bpp] : 0;
            const int up = prev ? prev[x] : 0;
            const int ul = (prev && x >= bpp) ? prev[x - bpp] : 0;
            dst[x] = static_cast<uint8_t>(src[x] - paeth(left, up, ul));
        }
        prev = src;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full in-memory PNG decode (8-bit, non-interlaced RGB/RGBA/gray) and a
// threaded batch front-end — the framework's native data-loader for the
// batched pipeline (models/batched.py). The reference's loader is
// cv::imread called serially per image (serial.cpp:22); here N images
// decode on a std::thread pool into one preallocated host buffer.

namespace {

struct PngInfo {
    uint32_t width = 0, height = 0;
    uint8_t bit_depth = 0, color_type = 0, interlace = 0;
};

inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

// Decode one PNG buffer to tightly-packed RGB8 (out = w*h*3).
// Returns 0 ok; -1 bad signature/structure; -2 unsupported format;
// -3 zlib error; -4 bad filter; -5 output size mismatch.
int decode_rgb8_one(const uint8_t* data, int64_t len, uint8_t* out,
                    int expect_w, int expect_h) {
    if (len < 8 || std::memcmp(data, kSig, 8) != 0) return -1;
    PngInfo info;
    std::vector<uint8_t> idat;
    std::vector<uint8_t> palette;  // 3 bytes per entry
    int64_t pos = 8;
    while (pos + 12 <= len) {
        const uint32_t clen = be32(data + pos);
        const uint8_t* ctype = data + pos + 4;
        const uint8_t* body = data + pos + 8;
        if (pos + 12 + clen > len) return -1;
        if (!std::memcmp(ctype, "IHDR", 4)) {
            if (clen < 13) return -1;
            info.width = be32(body);
            info.height = be32(body + 4);
            info.bit_depth = body[8];
            info.color_type = body[9];
            info.interlace = body[12];
        } else if (!std::memcmp(ctype, "PLTE", 4)) {
            palette.assign(body, body + clen);
        } else if (!std::memcmp(ctype, "IDAT", 4)) {
            idat.insert(idat.end(), body, body + clen);
        } else if (!std::memcmp(ctype, "IEND", 4)) {
            break;
        }
        pos += 12 + clen;
    }
    if (info.width == 0 || info.interlace != 0 || info.bit_depth != 8)
        return -2;
    if (expect_w > 0 && (int)info.width != expect_w) return -5;
    if (expect_h > 0 && (int)info.height != expect_h) return -5;
    int channels;
    switch (info.color_type) {
        case 0: channels = 1; break;
        case 2: channels = 3; break;
        case 3: channels = 1; break;
        case 4: channels = 2; break;
        case 6: channels = 4; break;
        default: return -2;
    }
    const int w = info.width, h = info.height;
    const int stride = w * channels;
    std::vector<uint8_t> raw((int64_t)h * (stride + 1));
    {
        uLongf dst_len = raw.size();
        if (uncompress(raw.data(), &dst_len, idat.data(), idat.size()) != Z_OK ||
            dst_len != raw.size())
            return -3;
    }
    std::vector<uint8_t> recon((int64_t)h * stride);
    if (unfilter_scanlines(raw.data(), recon.data(), h, stride, channels) != 0)
        return -4;
    // expand to RGB8
    for (int64_t i = 0; i < (int64_t)w * h; ++i) {
        const uint8_t* px = recon.data() + i * channels;
        uint8_t r, g, b;
        switch (info.color_type) {
            case 0: case 4: r = g = b = px[0]; break;
            case 3: {
                const int idx = px[0] * 3;
                if (idx + 2 >= (int)palette.size()) return -2;
                r = palette[idx]; g = palette[idx + 1]; b = palette[idx + 2];
                break;
            }
            default: r = px[0]; g = px[1]; b = px[2]; break;
        }
        out[i * 3] = r;
        out[i * 3 + 1] = g;
        out[i * 3 + 2] = b;
    }
    return 0;
}

}  // namespace

extern "C" {

// Probe dimensions. Returns 0 and fills w/h, or <0.
int png_get_size(const uint8_t* data, int64_t len, int* w, int* h) {
    if (len < 33 || std::memcmp(data, kSig, 8) != 0) return -1;
    if (std::memcmp(data + 12, "IHDR", 4) != 0) return -1;
    *w = (int)be32(data + 16);
    *h = (int)be32(data + 20);
    return 0;
}

int decode_png_rgb8(const uint8_t* data, int64_t len, uint8_t* out, int w,
                    int h) {
    return decode_rgb8_one(data, len, out, w, h);
}

// Batch decode: n same-sized PNG buffers into out[n, h, w, 3] using up
// to `threads` worker threads. Returns 0, or the first nonzero error.
int decode_png_batch_rgb8(const uint8_t** datas, const int64_t* lens, int n,
                          uint8_t* out, int w, int h, int threads) {
    if (threads < 1) threads = 1;
    if (threads > n) threads = n;
    std::atomic<int> next(0);
    std::atomic<int> err(0);
    const int64_t frame = (int64_t)w * h * 3;
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) return;
            const int rc = decode_rgb8_one(datas[i], lens[i], out + i * frame, w, h);
            if (rc != 0) {
                int expected = 0;
                err.compare_exchange_strong(expected, rc);
            }
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    return err.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Baseline-JPEG entropy decode — the sequential hot loop of JPEG ingest
// (utils/jpeg.py). Python resolves markers/tables and the vectorized
// dequant/IDCT; this function Huffman-decodes one restart segment of
// interleaved MCUs into raw coefficient blocks.
//
// Tables arrive as the same 16-bit LUTs the Python decoder builds
// (_Huff): lut_sym/lut_len[table][window16] -> (symbol, code bits).
// Table layout: per component c, DC table at index 2c, AC at 2c+1.

namespace {

struct BitReader {
    // 64-bit buffered MSB-first reader: peek16 is one shift+mask on the
    // hot path (the 3-byte reassembling reader it replaces was ~40% of
    // the scan decode).
    const uint8_t* data;
    int64_t nbytes;
    int64_t bytepos = 0;
    uint64_t buf = 0;
    int cnt = 0;  // valid bits in buf (low cnt bits)

    inline void fill() {
        while (cnt <= 56) {
            const uint64_t b = (bytepos < nbytes) ? data[bytepos] : 0;
            ++bytepos;
            buf = (buf << 8) | b;
            cnt += 8;
        }
    }

    inline int peek16() {
        if (cnt < 16) fill();
        return static_cast<int>((buf >> (cnt - 16)) & 0xFFFF);
    }

    // consumed = bits handed out so far (bytepos counts fetched bytes,
    // including zero-padding past the end; subtract what's unread)
    inline int64_t consumed() const { return bytepos * 8 - cnt; }
    inline bool ok(int64_t need) const {
        return consumed() + need <= nbytes * 8;
    }
    inline void drop(int n) { cnt -= n; }
};

inline int extend(int v, int s) {
    return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

}  // namespace

// Decode n_mcu interleaved MCUs. block_comp: component index of each of
// blocks_per_mcu blocks in an MCU. out: (n_mcu * blocks_per_mcu, 64)
// int32, natural (zigzag) coefficient order. Returns 0 on success,
// -1 invalid Huffman code, -2 exhausted data, -3 AC overflow.
extern "C" int jpeg_decode_scan(const uint8_t* data, int64_t nbytes, int n_comps,
                     const uint8_t* lut_sym, const uint8_t* lut_len,
                     const int32_t* block_comp, int blocks_per_mcu,
                     int64_t n_mcu, int32_t* out) {
    BitReader br{data, nbytes};
    std::vector<int> pred(n_comps, 0);
    for (int64_t m = 0; m < n_mcu; ++m) {
        for (int j = 0; j < blocks_per_mcu; ++j) {
            int c = block_comp[j];
            const uint8_t* dc_sym = lut_sym + (int64_t)(2 * c) * 65536;
            const uint8_t* dc_len = lut_len + (int64_t)(2 * c) * 65536;
            const uint8_t* ac_sym = lut_sym + (int64_t)(2 * c + 1) * 65536;
            const uint8_t* ac_len = lut_len + (int64_t)(2 * c + 1) * 65536;
            int32_t* blk = out + (m * blocks_per_mcu + j) * 64;
            std::memset(blk, 0, 64 * sizeof(int32_t));
            // DC
            int w = br.peek16();
            int len = dc_len[w];
            if (len == 0) return -1;
            if (!br.ok(len)) return -2;
            int s = dc_sym[w];
            br.drop(len);
            if (!br.ok(s)) return -2;
            int bits = s ? (br.peek16() >> (16 - s)) : 0;
            br.drop(s);
            pred[c] += extend(bits, s);
            blk[0] = pred[c];
            // AC
            int k = 1;
            while (k < 64) {
                w = br.peek16();
                len = ac_len[w];
                if (len == 0) return -1;
                if (!br.ok(len)) return -2;
                int rs = ac_sym[w];
                br.drop(len);
                int r = rs >> 4, sz = rs & 15;
                if (sz == 0) {
                    if (r == 15) { k += 16; continue; }
                    break;  // EOB
                }
                k += r;
                if (k > 63) return -3;
                if (!br.ok(sz)) return -2;
                int v = br.peek16() >> (16 - sz);
                br.drop(sz);
                blk[k] = extend(v, sz);
                ++k;
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Baseline-JPEG back half: dequantize + dezigzag + 8x8 IDCT + chroma
// upsample + YCbCr->RGB, from entropy-decoded coefficient blocks to the
// final uint8 raster. Completes the native ingest path begun by
// jpeg_decode_scan: the NumPy back half ran ~130 ms/MP (scatters, einsum
// IDCT, per-plane temporaries); this runs the same float32 math in one
// pass per stage. Matches utils/jpeg.py's pipeline exactly: orthonormal
// DCT basis, libjpeg "fancy" (triangular) 2x upsampling, BT.601
// YCbCr->RGB, round-half-even, clip.

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// M[k][x] = c(k)/2 * cos((2x+1) k pi / 16), float32 — identical to the
// _M basis in utils/jpeg.py; IDCT(X) = M^T X M.
struct DctBasis {
    float m[8][8];
    DctBasis() {
        for (int k = 0; k < 8; ++k)
            for (int x = 0; x < 8; ++x) {
                double v = std::cos((2.0 * x + 1.0) * k * M_PI / 16.0) * 0.5;
                if (k == 0) v *= 1.0 / std::sqrt(2.0);
                m[k][x] = static_cast<float>(v);
            }
    }
};
const DctBasis kDct;

// out[y][x] = sum_k sum_l M[k][y] * X[k][l] * M[l][x]  (+128)
inline void idct8x8(const float X[64], float* out, int out_stride) {
    float t[64];  // t = X M   (t[k][x] = sum_l X[k][l] M[l][x])
    for (int k = 0; k < 8; ++k)
        for (int x = 0; x < 8; ++x) {
            float acc = 0.f;
            for (int l = 0; l < 8; ++l) acc += X[k * 8 + l] * kDct.m[l][x];
            t[k * 8 + x] = acc;
        }
    for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) {
            float acc = 0.f;
            for (int k = 0; k < 8; ++k) acc += kDct.m[k][y] * t[k * 8 + x];
            out[y * out_stride + x] = acc + 128.0f;
        }
}

// Triangular ("fancy") 2x upsample along rows: dst has 2*n rows.
// dst[2i] = (3 s[i] + s[i-1]) / 4, dst[2i+1] = (3 s[i] + s[i+1]) / 4.
void upsample2_rows(const float* src, int sh, int sw, float* dst) {
    for (int i = 0; i < sh; ++i) {
        const float* s = src + (int64_t)i * sw;
        const float* sp = src + (int64_t)(i > 0 ? i - 1 : 0) * sw;
        const float* sn = src + (int64_t)(i + 1 < sh ? i + 1 : sh - 1) * sw;
        float* d0 = dst + (int64_t)(2 * i) * sw;
        float* d1 = dst + (int64_t)(2 * i + 1) * sw;
        for (int x = 0; x < sw; ++x) {
            d0[x] = (3.0f * s[x] + sp[x]) * 0.25f;
            d1[x] = (3.0f * s[x] + sn[x]) * 0.25f;
        }
    }
}

// Triangular 2x upsample along columns: dst has 2*sw columns.
void upsample2_cols(const float* src, int sh, int sw, float* dst) {
    for (int i = 0; i < sh; ++i) {
        const float* s = src + (int64_t)i * sw;
        float* d = dst + (int64_t)i * (2 * sw);
        for (int x = 0; x < sw; ++x) {
            float left = s[x > 0 ? x - 1 : 0];
            float right = s[x + 1 < sw ? x + 1 : sw - 1];
            d[2 * x] = (3.0f * s[x] + left) * 0.25f;
            d[2 * x + 1] = (3.0f * s[x] + right) * 0.25f;
        }
    }
}

// Nearest-neighbor upsample by integer factor along both axes.
void upsample_nearest(const float* src, int sh, int sw, int fy, int fx,
                      float* dst) {
    for (int y = 0; y < sh * fy; ++y) {
        const float* s = src + (int64_t)(y / fy) * sw;
        float* d = dst + (int64_t)y * (sw * fx);
        for (int x = 0; x < sw * fx; ++x) d[x] = s[x / fx];
    }
}

inline uint8_t round_clip_u8(float v) {
    // lrintf uses the current rounding mode (nearest-even) -> one
    // cvtss2si; matches np.round like nearbyintf but vectorizes
    long r = lrintf(v);
    if (r < 0) return 0;
    if (r > 255) return 255;
    return static_cast<uint8_t>(r);
}

}  // namespace

// blocks: (n_mcu, blocks_per_mcu, 64) int32 zigzag-order coefficients
//   (output of jpeg_decode_scan / the Python fallback).
// block_comp/block_v/block_h: per plan entry, the component index and
//   the (v, h) position of the block inside its component's MCU tile.
// comp_h/comp_v: per component sampling factors; qtab: (n_comps, 64)
//   int32 quant tables in zigzag order.
// out: (h, w, 3) uint8 RGB for 3 components, (h, w) gray for 1.
// Returns 0, or -1 for unsupported component counts.
extern "C" int jpeg_backend_rgb(const int32_t* blocks, int64_t n_mcu,
                                int blocks_per_mcu, const int32_t* block_comp,
                                const int32_t* block_v, const int32_t* block_h,
                                int n_comps, const int32_t* comp_h,
                                const int32_t* comp_v, const int32_t* qtab,
                                int mcux, int mcuy, int hmax, int vmax, int h,
                                int w, uint8_t* out) {
    if (n_comps != 1 && n_comps != 3) return -1;
    std::vector<std::vector<float>> planes(n_comps);  // full-res planes
    const int full_h = mcuy * vmax * 8, full_w = mcux * hmax * 8;

    auto decode_comp = [&](int ci) {
        const int cv = comp_v[ci], ch = comp_h[ci];
        const int ph = mcuy * cv * 8, pw = mcux * ch * 8;
        // uninitialized on purpose: every element is written by the
        // IDCT below (the plane is exactly the MCU grid)
        std::vector<float> plane;
        plane.reserve((int64_t)ph * pw);
        plane.resize((int64_t)ph * pw);
        const int32_t* q = qtab + (int64_t)ci * 64;
        // IDCT every block of this component straight into the plane
        for (int j = 0; j < blocks_per_mcu; ++j) {
            if (block_comp[j] != ci) continue;
            const int bv = block_v[j], bh = block_h[j];
            for (int64_t m = 0; m < n_mcu; ++m) {
                const int32_t* blk = blocks + (m * blocks_per_mcu + j) * 64;
                const int64_t my = m / mcux, mx = m % mcux;
                const int64_t by = my * cv + bv, bx = mx * ch + bh;
                float* dst = plane.data() + (by * 8) * (int64_t)pw + bx * 8;
                float X[64];
                std::memset(X, 0, sizeof(X));
                int nz = 0;
                for (int idx = 1; idx < 64; ++idx)
                    if (blk[idx]) {
                        X[kZigzag[idx]] =
                            static_cast<float>(blk[idx] * q[idx]);
                        nz = 1;
                    }
                if (!nz) {
                    // DC-only block: IDCT is the constant X00/8 + 128
                    const float v =
                        static_cast<float>(blk[0] * q[0]) * 0.125f + 128.0f;
                    for (int y = 0; y < 8; ++y)
                        for (int x = 0; x < 8; ++x) dst[y * pw + x] = v;
                    continue;
                }
                X[0] = static_cast<float>(blk[0] * q[0]);
                idct8x8(X, dst, pw);
            }
        }
        // upsample to full resolution
        int fy = vmax / cv, fx = hmax / ch;
        int cur_h = ph, cur_w = pw;
        if (fy == 2) {
            std::vector<float> up((int64_t)(2 * cur_h) * cur_w);
            upsample2_rows(plane.data(), cur_h, cur_w, up.data());
            plane.swap(up);
            cur_h *= 2;
            fy = 1;
        }
        if (fx == 2) {
            std::vector<float> up((int64_t)cur_h * (2 * cur_w));
            upsample2_cols(plane.data(), cur_h, cur_w, up.data());
            plane.swap(up);
            cur_w *= 2;
            fx = 1;
        }
        if (fy != 1 || fx != 1) {
            std::vector<float> up((int64_t)cur_h * fy * cur_w * fx);
            upsample_nearest(plane.data(), cur_h, cur_w, fy, fx, up.data());
            plane.swap(up);
            cur_h *= fy;
            cur_w *= fx;
        }
        (void)full_h;
        (void)full_w;
        planes[ci].swap(plane);
    };
    if (n_comps > 1) {
        std::vector<std::thread> pool;
        for (int ci = 0; ci < n_comps; ++ci)
            pool.emplace_back(decode_comp, ci);
        for (auto& t : pool) t.join();
    } else {
        decode_comp(0);
    }

    const int64_t pw3 = (int64_t)mcux * comp_h[0] * 8 * (hmax / comp_h[0]);
    if (n_comps == 1) {
        const float* y0 = planes[0].data();
        for (int yy = 0; yy < h; ++yy)
            for (int xx = 0; xx < w; ++xx)
                out[(int64_t)yy * w + xx] =
                    round_clip_u8(y0[(int64_t)yy * pw3 + xx]);
        return 0;
    }
    // all three planes are at full resolution now: width = mcux*hmax*8
    const int64_t fw = (int64_t)mcux * hmax * 8;
    const float* Y = planes[0].data();
    const float* Cb = planes[1].data();
    const float* Cr = planes[2].data();
    auto color_rows = [&](int y0r, int y1r) {
        for (int yy = y0r; yy < y1r; ++yy) {
            const float* yr = Y + (int64_t)yy * fw;
            const float* cbr = Cb + (int64_t)yy * fw;
            const float* crr = Cr + (int64_t)yy * fw;
            uint8_t* o = out + (int64_t)yy * w * 3;
            for (int xx = 0; xx < w; ++xx) {
                const float cb = cbr[xx] - 128.0f, cr = crr[xx] - 128.0f;
                const float yv = yr[xx];
                o[3 * xx] = round_clip_u8(yv + 1.402f * cr);
                o[3 * xx + 1] =
                    round_clip_u8(yv - 0.344136f * cb - 0.714136f * cr);
                o[3 * xx + 2] = round_clip_u8(yv + 1.772f * cb);
            }
        }
    };
    const int nthreads = 4;
    if (h >= 4 * nthreads) {
        std::vector<std::thread> pool;
        const int band = (h + nthreads - 1) / nthreads;
        for (int t = 0; t < nthreads; ++t) {
            const int y0r = t * band;
            const int y1r = y0r + band < h ? y0r + band : h;
            if (y0r < y1r) pool.emplace_back(color_rows, y0r, y1r);
        }
        for (auto& t : pool) t.join();
    } else {
        color_rows(0, h);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Progressive-JPEG entropy lanes (T.81 Annex G, Huffman): the per-block
// band/approximation bit loops of utils/jpeg.py _decode_progressive,
// one call per restart segment. Counterpart of the reference's single
// cv::imread call (serial.cpp:22); the pure-Python loops ran ~0.3 MP/s
// on a 2048x2048 progressive photo, these lanes restore batch-ingest
// speed.
//
// Shared conventions with jpeg_decode_scan: `data` is the
// stuffing-stripped entropy segment; Huffman tables arrive as 65536-
// entry symbol/length LUTs; coefficient grids are int32 (rows, cols,
// 64) in zigzag order. Error codes: -1 invalid code, -2 exhausted
// data, -3 band overflow, -4 bad refinement size.

// DC scan segment (first pass or refinement), interleaved or single
// component. plan_*: per block-in-unit component index and sampling
// offsets; comp_*: per scan-component grid geometry. Decodes units
// [start_unit, start_unit + n_units).
extern "C" int jpeg_decode_prog_dc(
    const uint8_t* data, int64_t nbytes,
    const uint8_t* lut_sym, const uint8_t* lut_len,  // (n_comps, 65536)
    int refine, int al,
    int n_comps,
    int32_t* const* comp_base,      // per scan-component grid base
    const int64_t* comp_stride,     // per comp: grid row stride in i32
    const int32_t* comp_ch, const int32_t* comp_cv,
    int blocks_per_unit,
    const int32_t* plan_comp, const int32_t* plan_v, const int32_t* plan_h,
    int64_t units_per_row,          // MCUs per row (or blocks for single)
    int64_t start_unit, int64_t n_units,
    int32_t* pred_io)               // per comp DC predictor, in/out
{
    (void)n_comps;  // geometry arrives via the per-comp arrays
    BitReader br{data, nbytes};
    for (int64_t u = 0; u < n_units; ++u) {
        const int64_t unit = start_unit + u;
        const int64_t uy = unit / units_per_row;
        const int64_t ux = unit % units_per_row;
        for (int j = 0; j < blocks_per_unit; ++j) {
            const int c = plan_comp[j];
            int32_t* blk = comp_base[c]
                + (uy * comp_cv[c] + plan_v[j]) * comp_stride[c]
                + (ux * comp_ch[c] + plan_h[j]) * 64;
            if (!refine) {
                const uint8_t* sym = lut_sym + (int64_t)c * 65536;
                const uint8_t* len = lut_len + (int64_t)c * 65536;
                const int w = br.peek16();
                const int l = len[w];
                if (l == 0) return -1;
                if (!br.ok(l)) return -2;
                const int s = sym[w];
                br.drop(l);
                if (!br.ok(s)) return -2;
                const int bits = s ? (br.peek16() >> (16 - s)) : 0;
                br.drop(s);
                pred_io[c] += extend(bits, s);
                // int64 product: the predictor can reach +-2^26 on
                // hostile streams and al is <= 15, so a 32-bit shift
                // would be UB; the truncating cast is well-defined
                blk[0] = (int32_t)((int64_t)pred_io[c] * ((int64_t)1 << al));
            } else {
                if (!br.ok(1)) return -2;
                if (br.peek16() >> 15) blk[0] |= (int32_t)1 << al;
                br.drop(1);
            }
        }
    }
    return 0;
}

// AC scan segment (always single-component). First pass (refine == 0)
// decodes the ss..se zigzag band with EOBn runs; refinement appends one
// magnitude bit per already-nonzero coefficient and introduces new
// +-(1<<al) values. eobrun resets at segment (restart) boundaries, so
// no state crosses calls.
extern "C" int jpeg_decode_prog_ac(
    const uint8_t* data, int64_t nbytes,
    const uint8_t* lut_sym, const uint8_t* lut_len,  // one AC table
    int refine, int ss, int se, int al,
    int32_t* coef_base, int64_t row_stride,
    int64_t blocks_per_row,
    int64_t start_unit, int64_t n_units)
{
    BitReader br{data, nbytes};
    const int32_t p1 = (int32_t)1 << al;
    const int32_t m1 = -p1;
    int64_t eobrun = 0;
    for (int64_t u = 0; u < n_units; ++u) {
        const int64_t unit = start_unit + u;
        int32_t* blk = coef_base
            + (unit / blocks_per_row) * row_stride
            + (unit % blocks_per_row) * 64;
        if (!refine) {
            if (eobrun > 0) { --eobrun; continue; }
            int k = ss;
            while (k <= se) {
                const int w = br.peek16();
                const int l = lut_len[w];
                if (l == 0) return -1;
                if (!br.ok(l)) return -2;
                const int rs = lut_sym[w];
                br.drop(l);
                const int r = rs >> 4, s = rs & 15;
                if (s == 0) {
                    if (r == 15) { k += 16; continue; }
                    eobrun = ((int64_t)1 << r) - 1;
                    if (r) {
                        if (!br.ok(r)) return -2;
                        eobrun += br.peek16() >> (16 - r);
                        br.drop(r);
                    }
                    break;
                }
                k += r;
                if (k > se) return -3;
                if (!br.ok(s)) return -2;
                const int v = br.peek16() >> (16 - s);
                br.drop(s);
                blk[k] = (int32_t)extend(v, s) * p1;
                ++k;
            }
        } else {
            int k = ss;
            if (eobrun == 0) {
                while (k <= se) {
                    const int w = br.peek16();
                    const int l = lut_len[w];
                    if (l == 0) return -1;
                    if (!br.ok(l)) return -2;
                    const int rs = lut_sym[w];
                    br.drop(l);
                    int r = rs >> 4;
                    const int s = rs & 15;
                    int32_t newval = 0;
                    if (s == 0) {
                        if (r != 15) {
                            eobrun = (int64_t)1 << r;
                            if (r) {
                                if (!br.ok(r)) return -2;
                                eobrun += br.peek16() >> (16 - r);
                                br.drop(r);
                            }
                            break;
                        }
                        // ZRL: r == 15, skip 16 zero-history coefficients
                    } else {
                        if (s != 1) return -4;
                        if (!br.ok(1)) return -2;
                        newval = (br.peek16() >> 15) ? p1 : m1;
                        br.drop(1);
                    }
                    while (k <= se) {
                        const int32_t v = blk[k];
                        if (v != 0) {
                            if (!br.ok(1)) return -2;
                            const int bit = br.peek16() >> 15;
                            br.drop(1);
                            if (bit && (v & p1) == 0)
                                blk[k] = v + (v >= 0 ? p1 : m1);
                        } else {
                            if (r == 0) break;
                            --r;
                        }
                        ++k;
                    }
                    if (newval && k <= se) blk[k] = newval;
                    ++k;
                }
            }
            if (eobrun > 0) {
                while (k <= se) {
                    const int32_t v = blk[k];
                    if (v != 0) {
                        if (!br.ok(1)) return -2;
                        const int bit = br.peek16() >> 15;
                        br.drop(1);
                        if (bit && (v & p1) == 0)
                            blk[k] = v + (v >= 0 ? p1 : m1);
                    }
                    ++k;
                }
                --eobrun;
            }
        }
    }
    return 0;
}
