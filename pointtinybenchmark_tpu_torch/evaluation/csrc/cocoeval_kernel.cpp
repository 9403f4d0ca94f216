// Native evaluation loops: the C++ counterpart of pycocotools' Cython hot
// loop, the port's own copy of the JAX package's native/cocoeval_kernel.cpp.
//
// Exposed through a plain C ABI and loaded with ctypes
// (pointtinybenchmark_tpu_torch/evaluation/native.py, which builds it with
// g++ at first use). The matching semantics mirror the Python loops of
// evaluation/cocoeval.py's _evaluate_img (pycocotools-derived greedy
// matching with the IoD-for-ignore extension), which stay beside it as the
// reference (COCOExpandEval(native=False)).
#include <cmath>
#include <cstdint>
#include <algorithm>
#include <vector>

extern "C" {

// Pairwise IoU (or IoD for flagged gt columns) between dets and gts.
// det/gt boxes are xywh rows. out is (n_det x n_gt), row-major.
void bbox_iou_matrix(const double* det, int64_t n_det,
                     const double* gt, int64_t n_gt,
                     const uint8_t* iod_cols,
                     double* out) {
    for (int64_t d = 0; d < n_det; ++d) {
        const double dx1 = det[d * 4 + 0], dy1 = det[d * 4 + 1];
        const double dw = det[d * 4 + 2], dh = det[d * 4 + 3];
        const double dx2 = dx1 + dw, dy2 = dy1 + dh;
        const double darea = dw * dh;
        for (int64_t g = 0; g < n_gt; ++g) {
            const double gx1 = gt[g * 4 + 0], gy1 = gt[g * 4 + 1];
            const double gw = gt[g * 4 + 2], gh = gt[g * 4 + 3];
            const double gx2 = gx1 + gw, gy2 = gy1 + gh;
            const double iw = std::min(dx2, gx2) - std::max(dx1, gx1);
            const double ih = std::min(dy2, gy2) - std::max(dy1, gy1);
            double inter = (iw > 0 && ih > 0) ? iw * ih : 0.0;
            double denom = iod_cols[g] ? darea : (darea + gw * gh - inter);
            out[d * n_gt + g] = inter / std::max(denom, 1e-10);
        }
    }
}

// Greedy det->gt matching for one (image, category, areaRng) cell at T iou
// thresholds. Inputs are pre-sorted: gts ignored-last, dets by score desc.
//
// ious:       (n_det x n_gt) from bbox_iou_matrix (gt-sorted order)
// gt_ignore:  (n_gt) 0/1
// crowd_like: (n_gt) 0/1 — matched by IoD threshold when use_iod != 0
// thrs:       (n_thr) IoU thresholds
// iod_thrs:   (n_thr) IoD thresholds (= f(thr))
// outputs dtm (n_thr x n_det) matched gt index + 1 (0 unmatched),
//         gtm (n_thr x n_gt) matched det index + 1,
//         dt_ig (n_thr x n_det) 0/1
void greedy_match(const double* ious, int64_t n_det, int64_t n_gt,
                  const uint8_t* gt_ignore, const uint8_t* crowd_like,
                  const double* thrs, const double* iod_thrs, int64_t n_thr,
                  int use_iod,
                  int64_t* dtm, int64_t* gtm, uint8_t* dt_ig) {
    for (int64_t t = 0; t < n_thr; ++t) {
        const double thr = thrs[t];
        const double iod_t = iod_thrs[t];
        int64_t* gtm_t = gtm + t * n_gt;
        int64_t* dtm_t = dtm + t * n_det;
        uint8_t* dig_t = dt_ig + t * n_det;
        for (int64_t d = 0; d < n_det; ++d) {
            const double* row = ious + d * n_gt;
            // pass 1: best-IoU real gt
            double best = std::min(thr, 1.0 - 1e-10);
            int64_t m = -1;
            for (int64_t g = 0; g < n_gt; ++g) {
                if (gt_ignore[g]) break;  // sorted: ignored last
                if (gtm_t[g] > 0) continue;
                if (row[g] < best) continue;
                best = row[g];
                m = g;
            }
            if (m == -1) {
                // pass 2: ignore regions (IoD threshold when enabled)
                double best2 = -1.0;
                for (int64_t g = 0; g < n_gt; ++g) {
                    if (!gt_ignore[g]) continue;
                    if (gtm_t[g] > 0 && !crowd_like[g]) continue;
                    const double th = (use_iod && crowd_like[g]) ? iod_t : thr;
                    const double v = row[g];
                    if (v < std::max(std::min(th, 1.0 - 1e-10), 1e-10))
                        continue;
                    if (v <= best2) continue;
                    best2 = v;
                    m = g;
                }
            }
            if (m == -1) continue;
            dig_t[d] = gt_ignore[m];
            dtm_t[d] = m + 1;
            gtm_t[m] = d + 1;
        }
    }
}

}  // extern "C"

// RLE-domain mask IoU — the counterpart of pycocotools' rleIou/rleArea
// (maskApi.c): intersection computed by a two-pointer merge of the two
// column-major run lists, never densifying the masks. O(runs_d + runs_g)
// per pair vs O(H*W) for the bitmap formulation.
//
// Inputs: concatenated uncompressed counts (alternating 0-runs/1-runs,
// column-major order, pycocotools convention) with per-mask offsets
// (n+1 entries, offs[i]..offs[i+1] spans mask i's counts). iscrowd gt
// columns use union = area(dt) (IoD), matching maskUtils.iou.
static double rle_area(const int64_t* cnts, int64_t n) {
    double a = 0;
    for (int64_t i = 1; i < n; i += 2) a += (double)cnts[i];
    return a;
}

static double rle_intersection(const int64_t* ca, int64_t na,
                               const int64_t* cb, int64_t nb) {
    // positions advance through alternating runs; value of run i is i&1
    double inter = 0;
    int64_t ia = 0, ib = 0;
    int64_t ra = na > 0 ? ca[0] : 0;   // remaining length of current a-run
    int64_t rb = nb > 0 ? cb[0] : 0;
    while (ia < na && ib < nb) {
        // skip exhausted runs (zero-length runs are legal in RLE)
        if (ra == 0) { if (++ia < na) ra = ca[ia]; continue; }
        if (rb == 0) { if (++ib < nb) rb = cb[ib]; continue; }
        const int64_t step = ra < rb ? ra : rb;
        if ((ia & 1) && (ib & 1)) inter += (double)step;
        ra -= step;
        rb -= step;
    }
    return inter;
}

extern "C" void rle_iou_matrix(
                    const int64_t* d_cnts, const int64_t* d_offs,
                    int64_t n_det,
                    const int64_t* g_cnts, const int64_t* g_offs,
                    int64_t n_gt,
                    const uint8_t* iscrowd,
                    double* out) {
    std::vector<double> d_area(n_det), g_area(n_gt);
    for (int64_t d = 0; d < n_det; ++d)
        d_area[d] = rle_area(d_cnts + d_offs[d], d_offs[d + 1] - d_offs[d]);
    for (int64_t g = 0; g < n_gt; ++g)
        g_area[g] = rle_area(g_cnts + g_offs[g], g_offs[g + 1] - g_offs[g]);
    for (int64_t d = 0; d < n_det; ++d) {
        const int64_t* ca = d_cnts + d_offs[d];
        const int64_t na = d_offs[d + 1] - d_offs[d];
        for (int64_t g = 0; g < n_gt; ++g) {
            const double inter = rle_intersection(
                ca, na, g_cnts + g_offs[g], g_offs[g + 1] - g_offs[g]);
            const double denom = iscrowd[g]
                ? d_area[d] : (d_area[d] + g_area[g] - inter);
            out[d * n_gt + g] = denom > 0 ? inter / denom : 0.0;
        }
    }
}
