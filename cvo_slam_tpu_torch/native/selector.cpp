// Native DSO pixel-selector hot loops (host-side frontend).
//
// C++ implementation of the per-frame selection passes — the host bottleneck
// of the tracking pipeline (the device owns all point-cloud math; this feeds
// it). Semantics are identical to frontend/selector.py (itself
// a re-expression of reference PixelSelector2.cpp): per-32x32-block gradient
// histogram quantiles with 3x3 smoothing, and the 3-level hierarchical
// pot/2pot/4pot selection with raster-argmax tie-breaking and the
// lock-after-first-level-1-selection rule for level-2 candidates.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Built on first use by frontend/native.py into the package's build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// thsSmoothed (h32*w32) from the level-0 absolute squared gradients.
void dso_make_hists(const float* ag0, int w, int h, float* out) {
    const int w32 = w / 32, h32 = h / 32;
    std::vector<float> ths(static_cast<size_t>(w32) * h32);
    int hist[50];
    for (int by = 0; by < h32; ++by) {
        for (int bx = 0; bx < w32; ++bx) {
            std::memset(hist, 0, sizeof(hist));
            for (int j = 0; j < 32; ++j) {
                const int jt = j + 32 * by;
                if (jt > h - 2 || jt < 1) continue;
                const float* row = ag0 + static_cast<size_t>(jt) * w;
                for (int i = 0; i < 32; ++i) {
                    const int it = i + 32 * bx;
                    if (it > w - 2 || it < 1) continue;
                    int g = static_cast<int>(std::sqrt(row[it]));
                    if (g > 48) g = 48;
                    hist[g + 1]++;
                    hist[0]++;
                }
            }
            int th = static_cast<int>(hist[0] * 0.5f + 0.5f);
            int q = 90;
            for (int i = 0; i < 90; ++i) {
                th -= (i + 1 < 50) ? hist[i + 1] : 0;
                if (th < 0) { q = i; break; }
            }
            ths[static_cast<size_t>(by) * w32 + bx] = static_cast<float>(q + 7);
        }
    }
    for (int by = 0; by < h32; ++by) {
        for (int bx = 0; bx < w32; ++bx) {
            float sum = 0.0f, num = 0.0f;
            for (int dy = -1; dy <= 1; ++dy) {
                for (int dx = -1; dx <= 1; ++dx) {
                    const int y = by + dy, x = bx + dx;
                    if (y < 0 || y >= h32 || x < 0 || x >= w32) continue;
                    sum += ths[static_cast<size_t>(y) * w32 + x];
                    num += 1.0f;
                }
            }
            const float m = sum / num;
            out[static_cast<size_t>(by) * w32 + bx] = m * m;
        }
    }
}

// One hierarchical selection pass. ag0/ag1/ag2 are the 3 pyramid levels of
// abs-squared gradients; ths is the smoothed block threshold map (h32*w32).
// status (h*w) receives {0,1,2,4}; counts[3] receives (n2, n3, n4).
void dso_select(const float* ag0, int w, int h,
                const float* ag1, int w1, int h1,
                const float* ag2, int w2, int h2,
                const float* ths, int pot, float th_factor,
                uint8_t* status, int32_t* counts) {
    const int w32 = w / 32, h32 = h / 32;
    const float dw1 = 0.75f, dw2 = 0.75f * 0.75f;
    std::memset(status, 0, static_cast<size_t>(w) * h);

    const int bs1 = pot, bs2 = 2 * pot, bs4 = 4 * pot;
    const int hb1 = (h + bs1 - 1) / bs1, wb1 = (w + bs1 - 1) / bs1;
    const int hb2 = (h + bs2 - 1) / bs2, wb2 = (w + bs2 - 1) / bs2;
    const int hb4 = (h + bs4 - 1) / bs4, wb4 = (w + bs4 - 1) / bs4;

    // precompute per-pixel validity and sampled coarse gradients lazily via
    // inline lambdas (memory-light; the image is scanned once per level)
    auto pixel_th0 = [&](int x, int y) {
        const int bx = clampi(x >> 5, 0, w32 - 1);
        const int by = clampi(y >> 5, 0, h32 - 1);
        return ths[static_cast<size_t>(by) * w32 + bx] * th_factor;
    };
    auto in_border = [&](int x, int y) {
        return x >= 4 && x < w - 5 && y >= 4 && y <= h - 4;
    };
    auto ag1p = [&](int x, int y) {
        const int sx = clampi(static_cast<int>(x * 0.5f + 0.25f), 0, w1 - 1);
        const int sy = clampi(static_cast<int>(y * 0.5f + 0.25f), 0, h1 - 1);
        return ag1[static_cast<size_t>(sy) * w1 + sx];
    };
    auto ag2p = [&](int x, int y) {
        const int sx = clampi(static_cast<int>(x * 0.25f + 0.125f), 0, w2 - 1);
        const int sy = clampi(static_cast<int>(y * 0.25f + 0.125f), 0, h2 - 1);
        return ag2[static_cast<size_t>(sy) * w2 + sx];
    };

    int n2 = 0, n3 = 0, n4 = 0;

    // level-0: raster argmax of ag0 among valid0 per pot tile
    std::vector<uint8_t> any0_2(static_cast<size_t>(hb2) * wb2, 0);
    std::vector<uint8_t> any0_4(static_cast<size_t>(hb4) * wb4, 0);
    for (int ty = 0; ty < hb1; ++ty) {
        for (int tx = 0; tx < wb1; ++tx) {
            const int y0 = ty * bs1, x0 = tx * bs1;
            const int y1 = std::min(y0 + bs1, h), x1 = std::min(x0 + bs1, w);
            float best = -1.0f;
            int bi = -1;
            for (int y = y0; y < y1; ++y) {
                for (int x = x0; x < x1; ++x) {
                    if (!in_border(x, y)) continue;
                    const float v = ag0[static_cast<size_t>(y) * w + x];
                    if (v > pixel_th0(x, y)) {
                        any0_2[static_cast<size_t>(y / bs2) * wb2 + x / bs2] = 1;
                        any0_4[static_cast<size_t>(y / bs4) * wb4 + x / bs4] = 1;
                        if (v > best) { best = v; bi = y * w + x; }
                    }
                }
            }
            if (bi > 0) { status[bi] = 1; ++n2; }
        }
    }

    // level-1: 2pot tiles with no valid0 pixel anywhere
    std::vector<uint8_t> pick1(static_cast<size_t>(hb2) * wb2, 0);
    for (int ty = 0; ty < hb2; ++ty) {
        for (int tx = 0; tx < wb2; ++tx) {
            if (any0_2[static_cast<size_t>(ty) * wb2 + tx]) continue;
            const int y0 = ty * bs2, x0 = tx * bs2;
            const int y1 = std::min(y0 + bs2, h), x1 = std::min(x0 + bs2, w);
            float best = -1.0f;
            int bi = -1;
            for (int y = y0; y < y1; ++y) {
                for (int x = x0; x < x1; ++x) {
                    if (!in_border(x, y)) continue;
                    const float v = ag1p(x, y);
                    if (v > pixel_th0(x, y) * dw1 && v > best) {
                        best = v; bi = y * w + x;
                    }
                }
            }
            if (bi > 0) {
                status[bi] = 2;
                ++n3;
                pick1[static_cast<size_t>(ty) * wb2 + tx] = 1;
            }
        }
    }

    // level-2: 4pot tiles with no valid0; candidate pool limited to 2pot
    // sub-blocks up to and including the first level-1-selecting one
    for (int ty = 0; ty < hb4; ++ty) {
        for (int tx = 0; tx < wb4; ++tx) {
            if (any0_4[static_cast<size_t>(ty) * wb4 + tx]) continue;
            float best = -1.0f;
            int bi = -1;
            bool locked = false;
            for (int sub = 0; sub < 4 && !locked; ++sub) {
                const int sy = ty * 2 + sub / 2, sx = tx * 2 + sub % 2;
                if (sy >= hb2 || sx >= wb2) continue;
                const int y0 = sy * bs2, x0 = sx * bs2;
                const int y1 = std::min(y0 + bs2, h);
                const int x1 = std::min(x0 + bs2, w);
                for (int y = y0; y < y1; ++y) {
                    for (int x = x0; x < x1; ++x) {
                        if (!in_border(x, y)) continue;
                        const float v = ag2p(x, y);
                        if (v > pixel_th0(x, y) * dw2 && v > best) {
                            best = v; bi = y * w + x;
                        }
                    }
                }
                if (pick1[static_cast<size_t>(sy) * wb2 + sx]) locked = true;
            }
            if (bi > 0) { status[bi] = 4; ++n4; }
        }
    }

    counts[0] = n2;
    counts[1] = n3;
    counts[2] = n4;
}

}  // extern "C"
