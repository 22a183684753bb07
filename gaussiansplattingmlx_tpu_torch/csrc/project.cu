// The projection and the SH colour, forward and backward.
//
// No TPU kernel: these replace the JAX package's plain ops/projection.py
// `project_gaussians` and utils/sh.py `sh_to_color`, which XLA fuses on the
// TPU.  In PyTorch the same math is ~100 small kernels over [N] tensors and
// as many autograd nodes, each reading and writing whole [N] (or [N, K, 3])
// tensors.
//
// project_fwd_kernel: one thread a Gaussian reads its mean, scale,
// quaternion and active flag (44 B) and writes means2d, depth, cov2d, conic,
// radius and rect (64 B).  project_bwd_kernel recomputes the forward from the
// same inputs (nothing is saved in between) and writes d means, d scales and
// d quats (40 B) from the cotangents of means2d, depth, cov2d and conic.
//
// sh_color_fwd_kernel / sh_color_bwd_kernel: the SH degree (0-4) is a
// template parameter.  The coefficients [N, K, 3] are 192 of the ~210 B a
// Gaussian moves each way at K = 16.  A block of 128 threads moves its 128
// Gaussians' coefficient rows between device and shared memory as
// coalesced 16-byte accesses (neighbouring threads on neighbouring
// addresses), into rows padded to an odd stride, so that each thread then
// reads (and, in the backward, writes) its own row without bank conflicts.
// The backward writes all K rows of d shs, zeros above the degree.
//
// Bound: bytes at 3.35 TB/s.  The operations (~300 a Gaussian for the
// projection, ~140 for the SH colour at degree 3) are two orders below.
//
// Bits: every forward value is built from correctly rounded multiplies, adds,
// divides and square roots in the plain path's order on the card, sums of 3
// and 4 terms in the order of PyTorch's CUDA reductions (`sum3`); `mul`
// (__fmul_rn) keeps nvcc from contracting a multiply and an add into an FMA.
// So the forward equals the plain path's on the card bit for bit, radii and
// rects included, and staging sees the same pairs.  (On the CPU PyTorch sums
// left to right and rounds its vectorised square root differently.)
// The backward recomputes the same values; its own arithmetic may contract.
// Where the plain path uses torch.maximum / torch.minimum the backward splits
// the gradient in half at a tie, and a `where` passes none to its unselected
// branch.
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// The launch's constants, in the order the wrapper packs them.
struct ProjectConsts {
    float width, height;  // the image (rects clamp at width - 1, height - 1)
    float z_cull, ndc_w_eps, tanfov_clip, cov2d_dilation, radius_eigen_eps;
    float quat_eps_sq;  // quat_norm_eps squared in double, then rounded
    float fov_x, fov_y, focal_x, focal_y;  // where the pointers below are null
};
constexpr int kConsts = 12;
static_assert(sizeof(ProjectConsts) == kConsts * sizeof(float), "packed floats");

// Device scalars of the camera (0-d float32 tensors), or null.
struct CameraScalars {
    const float* fov_x;
    const float* fov_y;
    const float* focal_x;
    const float* focal_y;
};

// The cotangents of the projection's outputs, each null (no gradient) or
// rows of a row stride (the columns contiguous): autograd hands the backward
// column slices of the packed [N, 11] records' cotangent.
struct Cotangents {
    const float* means2d;
    const float* depths;
    const float* cov2d;
    const float* conic;
    int64_t means2d_stride, depths_stride, cov2d_stride, conic_stride;
};

// The camera as a block reads it: row-vector view and projection matrices,
// the EWA clamp limits and the focal lengths.
struct Camera {
    float view[16];
    float proj[16];
    float lim_x, lim_y, fx, fy;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// torch.sum over a last dimension of 3 as PyTorch's CUDA reduction adds the
// terms (two accumulators, even and odd terms); of 4 it is (a0 + a2) +
// (a1 + a3).
__device__ __forceinline__ float sum3(float a0, float a1, float a2) { return (a0 + a2) + a1; }

// The EWA clamp limits 1.3 tan(fov / 2) and the focal lengths.
__device__ __forceinline__ void camera_scalars(Camera& cam, const ProjectConsts& c, float fov_x,
                                               float fov_y, float focal_x, float focal_y) {
    cam.lim_x = mul(tanf(mul(fov_x, 0.5f)), c.tanfov_clip);
    cam.lim_y = mul(tanf(mul(fov_y, 0.5f)), c.tanfov_clip);
    cam.fx = focal_x;
    cam.fy = focal_y;
}

// One Gaussian's forward, with the intermediates its backward needs.
struct Projected {
    float pv[4], pc[4];  // view- and clip-space point
    bool visible;
    float w_inv;
    float mean_x, mean_y;
    float qn[4], qnorm;  // normalised quaternion, its norm
    float R[9], L[9], S[9];  // rotation, R diag(s), cov3d (row-major)
    float t2, clip_x, clip_y, tx, ty;
    float b0[3], b1[3], c3b0[3], c3b1[3];  // J W rows, cov3d times them
    float c00, c01, c10, c11;
    bool sel;  // visible and det > 1e-12: the conic divides by det
    float det;  // the divisor: det where sel, else 1
};

__device__ __forceinline__ void project_one(const Camera& cam, const ProjectConsts& c,
                                            const float m[3], const float s[3], const float q[4],
                                            bool active, Projected& f) {
    const float* V = cam.view;
    const float* P = cam.proj;
    // NDC projection (row vectors: p_view = [m, 1] V, p_clip = p_view P).
    for (int j = 0; j < 4; ++j)
        f.pv[j] = ((mul(m[0], V[j]) + mul(m[1], V[4 + j])) + mul(m[2], V[8 + j])) + V[12 + j];
    for (int j = 0; j < 4; ++j)
        f.pc[j] = ((mul(f.pv[0], P[j]) + mul(f.pv[1], P[4 + j])) + mul(f.pv[2], P[8 + j]))
                  + mul(f.pv[3], P[12 + j]);
    f.visible = f.pv[2] >= c.z_cull && active;
    const float w_den = f.visible ? f.pc[3] + c.ndc_w_eps : 1.0f;
    f.w_inv = 1.0f / w_den;
    f.mean_x = mul(mul(mul(f.pc[0], f.w_inv) + 1.0f, c.width) - 1.0f, 0.5f);
    f.mean_y = mul(mul(mul(f.pc[1], f.w_inv) + 1.0f, c.height) - 1.0f, 0.5f);

    // cov3d = (R diag(s)) (R diag(s))^T from the normalised quaternion.
    const float ss = (mul(q[0], q[0]) + mul(q[2], q[2])) + (mul(q[1], q[1]) + mul(q[3], q[3]));
    f.qnorm = sqrtf(ss + c.quat_eps_sq);
    for (int i = 0; i < 4; ++i) f.qn[i] = q[i] / f.qnorm;
    const float w = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
    f.R[0] = 1.0f - mul(2.0f, mul(y, y) + mul(z, z));
    f.R[1] = mul(2.0f, mul(x, y) - mul(w, z));
    f.R[2] = mul(2.0f, mul(x, z) + mul(w, y));
    f.R[3] = mul(2.0f, mul(x, y) + mul(w, z));
    f.R[4] = 1.0f - mul(2.0f, mul(x, x) + mul(z, z));
    f.R[5] = mul(2.0f, mul(y, z) - mul(w, x));
    f.R[6] = mul(2.0f, mul(x, z) - mul(w, y));
    f.R[7] = mul(2.0f, mul(y, z) + mul(w, x));
    f.R[8] = 1.0f - mul(2.0f, mul(x, x) + mul(y, y));
    for (int i = 0; i < 9; ++i) f.L[i] = mul(f.R[i], s[i % 3]);
    for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 3; ++k)
            f.S[3 * i + k] = sum3(mul(f.L[3 * i], f.L[3 * k]), mul(f.L[3 * i + 1], f.L[3 * k + 1]),
                                  mul(f.L[3 * i + 2], f.L[3 * k + 2]));

    // EWA cov2d: t is the view-space point (pv[0..2]); the clamp of t_z.
    f.t2 = f.visible ? f.pv[2] : 1.0f;
    f.clip_x = fminf(fmaxf(f.t2, -cam.lim_x), cam.lim_x);
    f.clip_y = fminf(fmaxf(f.t2, -cam.lim_y), cam.lim_y);
    f.tx = mul(f.pv[0] / f.clip_x, f.t2);
    f.ty = mul(f.pv[1] / f.clip_y, f.t2);
    const float tz = f.t2, tz2 = mul(tz, tz);
    const float j00 = cam.fx / tz, j02 = mul(-f.tx, cam.fx) / tz2;
    const float j11 = cam.fy / tz, j12 = mul(-f.ty, cam.fy) / tz2;
    for (int k = 0; k < 3; ++k) {  // W = view[:3, :3]^T
        f.b0[k] = mul(j00, V[4 * k]) + mul(j02, V[4 * k + 2]);
        f.b1[k] = mul(j11, V[4 * k + 1]) + mul(j12, V[4 * k + 2]);
    }
    for (int i = 0; i < 3; ++i) {
        const float* Si = f.S + 3 * i;
        f.c3b0[i] = sum3(mul(Si[0], f.b0[0]), mul(Si[1], f.b0[1]), mul(Si[2], f.b0[2]));
        f.c3b1[i] = sum3(mul(Si[0], f.b1[0]), mul(Si[1], f.b1[1]), mul(Si[2], f.b1[2]));
    }
    f.c00 = sum3(mul(f.b0[0], f.c3b0[0]), mul(f.b0[1], f.c3b0[1]), mul(f.b0[2], f.c3b0[2]))
            + c.cov2d_dilation;
    f.c01 = sum3(mul(f.b0[0], f.c3b1[0]), mul(f.b0[1], f.c3b1[1]), mul(f.b0[2], f.c3b1[2]));
    f.c10 = sum3(mul(f.b1[0], f.c3b0[0]), mul(f.b1[1], f.c3b0[1]), mul(f.b1[2], f.c3b0[2]));
    f.c11 = sum3(mul(f.b1[0], f.c3b1[0]), mul(f.b1[1], f.c3b1[1]), mul(f.b1[2], f.c3b1[2]))
            + c.cov2d_dilation;
    const float det = mul(f.c00, f.c11) - mul(f.c01, f.c10);
    f.sel = f.visible && det > 1e-12f;
    f.det = f.sel ? det : 1.0f;
}

// The projection's outputs of one Gaussian: radius 3 ceil(sqrt(lambda_max))
// and the screen rect, 0 where culled; the conic cov2d's inverse.
struct ProjectionRow {
    float mean_x, mean_y, depth, cov2d[4], conic[4], radius, rect_min[2], rect_max[2];
};

__device__ __forceinline__ ProjectionRow projection_row(const ProjectConsts& c,
                                                        const Projected& f) {
    ProjectionRow o;
    o.mean_x = f.mean_x;
    o.mean_y = f.mean_y;
    o.depth = f.pv[2];
    o.cov2d[0] = f.c00; o.cov2d[1] = f.c01; o.cov2d[2] = f.c10; o.cov2d[3] = f.c11;
    o.conic[0] = f.c11 / f.det;
    o.conic[1] = -f.c01 / f.det;
    o.conic[2] = -f.c10 / f.det;
    o.conic[3] = f.c00 / f.det;
    const float mid = mul(0.5f, f.c00 + f.c11);
    float v = mul(mid, mid) - f.det;
    v = v < c.radius_eigen_eps ? c.radius_eigen_eps : v;  // torch.maximum: NaN stays
    o.radius = f.visible ? mul(3.0f, ceilf(sqrtf(mid + sqrtf(v)))) : 0.0f;
    const float min_x = f.mean_x - o.radius, min_y = f.mean_y - o.radius;
    const float max_x = f.mean_x + o.radius, max_y = f.mean_y + o.radius;
    o.rect_min[0] = min_x < 0.0f ? 0.0f : min_x;
    o.rect_min[1] = min_y < 0.0f ? 0.0f : min_y;
    o.rect_max[0] = max_x > c.width - 1.0f ? c.width - 1.0f : max_x;
    o.rect_max[1] = max_y > c.height - 1.0f ? c.height - 1.0f : max_y;
    return o;
}

// The gradient factor of torch.maximum(a, b) for a (torch.minimum: the
// other comparison): half at a tie, all where a wins or is NaN, none where
// it loses.
__device__ __forceinline__ float max_share(float a, float b) {
    return a == b ? 0.5f : (a < b ? 0.0f : 1.0f);
}
__device__ __forceinline__ float min_share(float a, float b) {
    return a == b ? 0.5f : (a > b ? 0.0f : 1.0f);
}

// One Gaussian's VJP: the cotangents of means2d [2], depth, cov2d [4] and
// conic [4] (each null where none) -> d means, d scales, d quats.
__device__ __forceinline__ void projection_grad(const Camera& cam, const ProjectConsts& c,
                                                const Projected& f, const float s[3],
                                                const float* g_means2d, const float* g_depth,
                                                const float* g_cov2d, const float* g_conic,
                                                float d_m[3], float d_s[3], float d_q[4]) {
    const float* V = cam.view;
    const float* P = cam.proj;
    // cov2d and conic -> c00, c01, c10, c11 (the conic divides by det).
    float gc00 = 0.0f, gc01 = 0.0f, gc10 = 0.0f, gc11 = 0.0f;
    if (g_cov2d) {
        gc00 = g_cov2d[0]; gc01 = g_cov2d[1]; gc10 = g_cov2d[2]; gc11 = g_cov2d[3];
    }
    if (g_conic) {
        const float* gk = g_conic;
        const float inv = 1.0f / f.det;
        gc11 += gk[0] * inv;
        gc01 -= gk[1] * inv;
        gc10 -= gk[2] * inv;
        gc00 += gk[3] * inv;
        if (f.sel) {
            const float g_det = -(gk[0] * f.c11 - gk[1] * f.c01 - gk[2] * f.c10 + gk[3] * f.c00)
                                * inv * inv;
            gc00 += g_det * f.c11;
            gc11 += g_det * f.c00;
            gc01 -= g_det * f.c10;
            gc10 -= g_det * f.c01;
        }
    }

    // c = b^T cov3d b -> b0, b1 and cov3d; cov3d = L L^T -> d L = G L with
    // G = d cov3d + its transpose, symmetric to the bit as cov3d is: then a
    // sphere (isotropic scales, as training starts) gets exactly no rotation
    // gradient, as under autograd, not rounding noise.
    float gb0[3], gb1[3];
    const float cross = gc01 + gc10;
    for (int k = 0; k < 3; ++k) {
        gb0[k] = 2.0f * gc00 * f.c3b0[k] + cross * f.c3b1[k];
        gb1[k] = 2.0f * gc11 * f.c3b1[k] + cross * f.c3b0[k];
    }
    float G[9];
    for (int i = 0; i < 3; ++i)
        for (int k = i; k < 3; ++k) {
            G[3 * i + k] = 2.0f * gc00 * f.b0[i] * f.b0[k] + 2.0f * gc11 * f.b1[i] * f.b1[k]
                           + cross * (f.b0[i] * f.b1[k] + f.b1[i] * f.b0[k]);
            G[3 * k + i] = G[3 * i + k];
        }
    float gR[9];
    d_s[0] = d_s[1] = d_s[2] = 0.0f;
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const float gL = G[3 * i] * f.L[j] + G[3 * i + 1] * f.L[3 + j]
                             + G[3 * i + 2] * f.L[6 + j];
            gR[3 * i + j] = gL * s[j];
            d_s[j] += gL * f.R[3 * i + j];
        }
    const float w = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
    const float gqn[4] = {
        2.0f * (-z * gR[1] + y * gR[2] + z * gR[3] - x * gR[5] - y * gR[6] + x * gR[7]),
        2.0f * (y * gR[1] + z * gR[2] + y * gR[3] - w * gR[5] + z * gR[6] + w * gR[7]
                - 2.0f * x * (gR[4] + gR[8])),
        2.0f * (x * gR[1] + w * gR[2] + x * gR[3] + z * gR[5] - w * gR[6] + z * gR[7]
                - 2.0f * y * (gR[0] + gR[8])),
        2.0f * (-w * gR[1] + x * gR[2] + w * gR[3] + y * gR[5] + x * gR[6] + y * gR[7]
                - 2.0f * z * (gR[0] + gR[4]))};
    // qn = q / |q|: d q = (d qn - qn (qn . d qn)) / |q|.
    const float dot = w * gqn[0] + x * gqn[1] + y * gqn[2] + z * gqn[3];
    for (int i = 0; i < 4; ++i) d_q[i] = (gqn[i] - f.qn[i] * dot) / f.qnorm;

    // b = J W -> the Jacobian's entries -> tx, ty, tz -> the view point t.
    float gj00 = 0.0f, gj02 = 0.0f, gj11 = 0.0f, gj12 = 0.0f;
    for (int k = 0; k < 3; ++k) {
        gj00 += gb0[k] * V[4 * k];
        gj02 += gb0[k] * V[4 * k + 2];
        gj11 += gb1[k] * V[4 * k + 1];
        gj12 += gb1[k] * V[4 * k + 2];
    }
    const float tz = f.t2, inv_tz2 = 1.0f / (tz * tz), inv_tz3 = inv_tz2 / tz;
    const float gtx = -gj02 * cam.fx * inv_tz2;
    const float gty = -gj12 * cam.fy * inv_tz2;
    float gt2 = -(gj00 * cam.fx + gj11 * cam.fy) * inv_tz2
                + 2.0f * (gj02 * f.tx * cam.fx + gj12 * f.ty * cam.fy) * inv_tz3;
    // tx = t0 / clip_x * t2, clip_x = min(max(t2, -lim_x), lim_x); likewise y.
    const float gt0 = gtx * f.t2 / f.clip_x, gt1 = gty * f.t2 / f.clip_y;
    gt2 += gtx * (f.pv[0] / f.clip_x) + gty * (f.pv[1] / f.clip_y);
    const float gclip_x = -gtx * f.pv[0] * f.t2 / (f.clip_x * f.clip_x);
    const float gclip_y = -gty * f.pv[1] * f.t2 / (f.clip_y * f.clip_y);
    const float ux = fmaxf(f.t2, -cam.lim_x), uy = fmaxf(f.t2, -cam.lim_y);
    gt2 += gclip_x * min_share(ux, cam.lim_x) * max_share(f.t2, -cam.lim_x)
           + gclip_y * min_share(uy, cam.lim_y) * max_share(f.t2, -cam.lim_y);

    // The view point: t (t2 only where visible), the depth, and the clip
    // point through the NDC divide (w only where visible).
    float gpv[4] = {gt0, gt1, f.visible ? gt2 : 0.0f, 0.0f};
    if (g_depth) gpv[2] += *g_depth;
    if (g_means2d) {
        const float gn0 = g_means2d[0] * 0.5f * c.width, gn1 = g_means2d[1] * 0.5f * c.height;
        const float gw_inv = gn0 * f.pc[0] + gn1 * f.pc[1];
        const float gpc[4] = {gn0 * f.w_inv, gn1 * f.w_inv, 0.0f,
                              f.visible ? -gw_inv * f.w_inv * f.w_inv : 0.0f};
        for (int r = 0; r < 4; ++r)
            gpv[r] += gpc[0] * P[4 * r] + gpc[1] * P[4 * r + 1] + gpc[3] * P[4 * r + 3];
    }
    for (int r = 0; r < 3; ++r)
        d_m[r] = gpv[0] * V[4 * r] + gpv[1] * V[4 * r + 1] + gpv[2] * V[4 * r + 2]
                 + gpv[3] * V[4 * r + 3];
}

// SH constants: the plain path's Python floats, rounded to float32.
constexpr float C0 = static_cast<float>(0.28209479177387814);
constexpr float C1 = static_cast<float>(0.4886025119029199);
constexpr float C2_0 = static_cast<float>(1.0925484305920792);
constexpr float C2_1 = static_cast<float>(-1.0925484305920792);
constexpr float C2_2 = static_cast<float>(0.31539156525252005);
constexpr float C2_3 = static_cast<float>(-1.0925484305920792);
constexpr float C2_4 = static_cast<float>(0.5462742152960396);
constexpr float C3_0 = static_cast<float>(-0.5900435899266435);
constexpr float C3_1 = static_cast<float>(2.890611442640554);
constexpr float C3_2 = static_cast<float>(-0.4570457994644658);
constexpr float C3_3 = static_cast<float>(0.3731763325901154);
constexpr float C3_4 = static_cast<float>(-0.4570457994644658);
constexpr float C3_5 = static_cast<float>(1.445305721320277);
constexpr float C3_6 = static_cast<float>(-0.5900435899266435);
constexpr float C4_0 = static_cast<float>(2.5033429417967046);
constexpr float C4_1 = static_cast<float>(-1.7701307697799304);
constexpr float C4_2 = static_cast<float>(0.9461746957575601);
constexpr float C4_3 = static_cast<float>(-0.6690465435572892);
constexpr float C4_4 = static_cast<float>(0.10578554691520431);
constexpr float C4_5 = static_cast<float>(-0.6690465435572892);
constexpr float C4_6 = static_cast<float>(0.47308734787878004);
constexpr float C4_7 = static_cast<float>(-1.7701307697799304);
constexpr float C4_8 = static_cast<float>(0.6258357354491761);

// The multiplier of each coefficient row, as the plain path rounds it (a
// subtracted term's with its sign): colour = sum_k b[k] sh[k], left to right.
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
    b[0] = C0;
    if (DEG >= 1) {
        b[1] = -mul(C1, y);
        b[2] = mul(C1, z);
        b[3] = -mul(C1, x);
    }
    if (DEG >= 2) {
        const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
        const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
        b[4] = mul(C2_0, xy);
        b[5] = mul(C2_1, yz);
        b[6] = mul(C2_2, (mul(2.0f, zz) - xx) - yy);
        b[7] = mul(C2_3, xz);
        b[8] = mul(C2_4, xx - yy);
        if (DEG >= 3) {
            b[9] = mul(mul(C3_0, y), mul(3.0f, xx) - yy);
            b[10] = mul(mul(C3_1, xy), z);
            b[11] = mul(mul(C3_2, y), (mul(4.0f, zz) - xx) - yy);
            b[12] = mul(mul(C3_3, z), (mul(2.0f, zz) - mul(3.0f, xx)) - mul(3.0f, yy));
            b[13] = mul(mul(C3_4, x), (mul(4.0f, zz) - xx) - yy);
            b[14] = mul(mul(C3_5, z), xx - yy);
            b[15] = mul(mul(C3_6, x), xx - mul(3.0f, yy));
        }
        if (DEG >= 4) {
            b[16] = mul(mul(C4_0, xy), xx - yy);
            b[17] = mul(mul(C4_1, yz), mul(3.0f, xx) - yy);
            b[18] = mul(mul(C4_2, xy), mul(7.0f, zz) - 1.0f);
            b[19] = mul(mul(C4_3, yz), mul(7.0f, zz) - 3.0f);
            b[20] = mul(C4_4, mul(zz, mul(35.0f, zz) - 30.0f) + 3.0f);
            b[21] = mul(mul(C4_5, xz), mul(7.0f, zz) - 3.0f);
            b[22] = mul(mul(C4_6, xx - yy), mul(7.0f, zz) - 1.0f);
            b[23] = mul(mul(C4_7, xz), xx - mul(3.0f, yy));
            b[24] = mul(C4_8, mul(xx, xx - mul(3.0f, yy)) - mul(yy, mul(3.0f, xx) - yy));
        }
    }
}

// d colour / d (x, y, z) through each row: g[k] = sum over channels of the
// colour's cotangent times coefficient k.
template <int DEG>
__device__ __forceinline__ void sh_dir_grad(float x, float y, float z, const float* g,
                                            float& dx, float& dy, float& dz) {
    dx = dy = dz = 0.0f;
    if (DEG >= 1) {
        dy -= C1 * g[1];
        dz += C1 * g[2];
        dx -= C1 * g[3];
    }
    if (DEG >= 2) {
        const float xx = x * x, yy = y * y, zz = z * z;
        const float xy = x * y, yz = y * z, xz = x * z;
        dx += C2_0 * y * g[4] - 2.0f * C2_2 * x * g[6] + C2_3 * z * g[7]
              + 2.0f * C2_4 * x * g[8];
        dy += C2_0 * x * g[4] + C2_1 * z * g[5] - 2.0f * C2_2 * y * g[6]
              - 2.0f * C2_4 * y * g[8];
        dz += C2_1 * y * g[5] + 4.0f * C2_2 * z * g[6] + C2_3 * x * g[7];
        if (DEG >= 3) {
            dx += C3_0 * 6.0f * xy * g[9] + C3_1 * yz * g[10] - C3_2 * 2.0f * xy * g[11]
                  - C3_3 * 6.0f * xz * g[12] + C3_4 * (4.0f * zz - 3.0f * xx - yy) * g[13]
                  + C3_5 * 2.0f * xz * g[14] + C3_6 * 3.0f * (xx - yy) * g[15];
            dy += C3_0 * 3.0f * (xx - yy) * g[9] + C3_1 * xz * g[10]
                  + C3_2 * (4.0f * zz - xx - 3.0f * yy) * g[11] - C3_3 * 6.0f * yz * g[12]
                  - C3_4 * 2.0f * xy * g[13] - C3_5 * 2.0f * yz * g[14]
                  - C3_6 * 6.0f * xy * g[15];
            dz += C3_1 * xy * g[10] + C3_2 * 8.0f * yz * g[11]
                  + C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * g[12]
                  + C3_4 * 8.0f * xz * g[13] + C3_5 * (xx - yy) * g[14];
        }
        if (DEG >= 4) {
            const float z7 = 7.0f * zz;
            dx += C4_0 * y * (3.0f * xx - yy) * g[16] + C4_1 * 6.0f * xy * z * g[17]
                  + C4_2 * y * (z7 - 1.0f) * g[18] + C4_5 * z * (z7 - 3.0f) * g[21]
                  + C4_6 * 2.0f * x * (z7 - 1.0f) * g[22]
                  + C4_7 * 3.0f * z * (xx - yy) * g[23]
                  + C4_8 * 4.0f * x * (xx - 3.0f * yy) * g[24];
            dy += C4_0 * x * (xx - 3.0f * yy) * g[16] + C4_1 * 3.0f * z * (xx - yy) * g[17]
                  + C4_2 * x * (z7 - 1.0f) * g[18] + C4_3 * z * (z7 - 3.0f) * g[19]
                  - C4_6 * 2.0f * y * (z7 - 1.0f) * g[22] - C4_7 * 6.0f * xy * z * g[23]
                  + C4_8 * 4.0f * y * (yy - 3.0f * xx) * g[24];
            dz += C4_1 * y * (3.0f * xx - yy) * g[17] + C4_2 * 14.0f * xy * z * g[18]
                  + C4_3 * y * (3.0f * z7 - 3.0f) * g[19]
                  + C4_4 * z * (140.0f * zz - 60.0f) * g[20]
                  + C4_5 * x * (3.0f * z7 - 3.0f) * g[21]
                  + C4_6 * 14.0f * z * (xx - yy) * g[22] + C4_7 * x * (xx - 3.0f * yy) * g[23];
        }
    }
}

// One Gaussian's colour from its coefficient row (3 D floats, channel
// fastest): max(sum_k b[k] row[k] + 0.5, 0) (torch.maximum: NaN stays).
template <int DEG>
__device__ __forceinline__ void sh_color_row(const float* b, const float* row, float color[3]) {
    constexpr int D = (DEG + 1) * (DEG + 1);
    for (int ch = 0; ch < 3; ++ch) {
        float r = mul(b[0], row[ch]);
        for (int j = 1; j < D; ++j) r = r + mul(b[j], row[3 * j + ch]);
        r = r + 0.5f;
        color[ch] = r < 0.0f ? 0.0f : r;
    }
}

// One Gaussian's VJP of the colour at cotangent d_color: the row becomes d
// row (in place), d_dir d (mean - camera centre).
template <int DEG>
__device__ __forceinline__ void sh_color_grad(float x, float y, float z, const float* b,
                                              float* row, const float d_color[3],
                                              float d_dir[3]) {
    constexpr int D = (DEG + 1) * (DEG + 1);
    float d_res[3];
    for (int ch = 0; ch < 3; ++ch) {
        float r = mul(b[0], row[ch]);
        for (int j = 1; j < D; ++j) r = r + mul(b[j], row[3 * j + ch]);
        r = r + 0.5f;
        d_res[ch] = r < 0.0f ? 0.0f : (r == 0.0f ? 0.5f * d_color[ch] : d_color[ch]);
    }
    float gk[D];
    for (int j = 0; j < D; ++j)
        gk[j] = d_res[0] * row[3 * j] + d_res[1] * row[3 * j + 1] + d_res[2] * row[3 * j + 2];
    sh_dir_grad<DEG>(x, y, z, gk, d_dir[0], d_dir[1], d_dir[2]);
    for (int j = 0; j < D; ++j)
        for (int ch = 0; ch < 3; ++ch) row[3 * j + ch] = mul(d_res[ch], b[j]);
}

// ---- Blocks and launches.  Everything above is one Gaussian's math.

__device__ __forceinline__ void load_camera(Camera& cam, const float* __restrict__ view,
                                            const float* __restrict__ proj,
                                            const CameraScalars& cs, const ProjectConsts& c) {
    const int t = threadIdx.x;
    if (t < 16) {
        cam.view[t] = view[t];
    } else if (t < 32) {
        cam.proj[t - 16] = proj[t - 16];
    } else if (t == 32) {
        camera_scalars(cam, c, cs.fov_x ? *cs.fov_x : c.fov_x, cs.fov_y ? *cs.fov_y : c.fov_y,
                       cs.focal_x ? *cs.focal_x : c.focal_x, cs.focal_y ? *cs.focal_y : c.focal_y);
    }
}

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                   const float* __restrict__ quats, const float* __restrict__ active, int64_t n,
                   const float* __restrict__ view, const float* __restrict__ proj,
                   CameraScalars cs, ProjectConsts c, float* __restrict__ means2d,
                   float* __restrict__ depths, float* __restrict__ cov2d,
                   float* __restrict__ conic, float* __restrict__ radii,
                   float* __restrict__ rect_min, float* __restrict__ rect_max) {
    __shared__ Camera cam;
    load_camera(cam, view, proj, cs, c);
    __syncthreads();
    const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (g >= n) return;
    const float m[3] = {means[3 * g], means[3 * g + 1], means[3 * g + 2]};
    const float s[3] = {scales[3 * g], scales[3 * g + 1], scales[3 * g + 2]};
    const float q[4] = {quats[4 * g], quats[4 * g + 1], quats[4 * g + 2], quats[4 * g + 3]};
    Projected f;
    project_one(cam, c, m, s, q, active == nullptr || active[g] > 0.0f, f);
    const ProjectionRow o = projection_row(c, f);
    reinterpret_cast<float2*>(means2d)[g] = make_float2(o.mean_x, o.mean_y);
    depths[g] = o.depth;
    reinterpret_cast<float4*>(cov2d)[g] = make_float4(o.cov2d[0], o.cov2d[1], o.cov2d[2],
                                                      o.cov2d[3]);
    reinterpret_cast<float4*>(conic)[g] = make_float4(o.conic[0], o.conic[1], o.conic[2],
                                                      o.conic[3]);
    radii[g] = o.radius;
    reinterpret_cast<float2*>(rect_min)[g] = make_float2(o.rect_min[0], o.rect_min[1]);
    reinterpret_cast<float2*>(rect_max)[g] = make_float2(o.rect_max[0], o.rect_max[1]);
}

__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                   const float* __restrict__ quats, const float* __restrict__ active, int64_t n,
                   const float* __restrict__ view, const float* __restrict__ proj,
                   CameraScalars cs, ProjectConsts c, Cotangents ct, float* __restrict__ d_means,
                   float* __restrict__ d_scales, float* __restrict__ d_quats) {
    __shared__ Camera cam;
    load_camera(cam, view, proj, cs, c);
    __syncthreads();
    const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (g >= n) return;
    const float m[3] = {means[3 * g], means[3 * g + 1], means[3 * g + 2]};
    const float s[3] = {scales[3 * g], scales[3 * g + 1], scales[3 * g + 2]};
    const float q[4] = {quats[4 * g], quats[4 * g + 1], quats[4 * g + 2], quats[4 * g + 3]};
    Projected f;
    project_one(cam, c, m, s, q, active == nullptr || active[g] > 0.0f, f);
    float d_m[3], d_s[3], d_q[4];
    projection_grad(cam, c, f, s, ct.means2d ? ct.means2d + g * ct.means2d_stride : nullptr,
                    ct.depths ? ct.depths + g * ct.depths_stride : nullptr,
                    ct.cov2d ? ct.cov2d + g * ct.cov2d_stride : nullptr,
                    ct.conic ? ct.conic + g * ct.conic_stride : nullptr, d_m, d_s, d_q);
    for (int r = 0; r < 3; ++r) {
        d_means[3 * g + r] = d_m[r];
        d_scales[3 * g + r] = d_s[r];
    }
    reinterpret_cast<float4*>(d_quats)[g] = make_float4(d_q[0], d_q[1], d_q[2], d_q[3]);
}

// A block's coefficient rows <-> shared memory, row r at tile + r * (ROW + 1).
// `vec`: K is the degree's row count and the rows start 16-byte aligned, so
// the block's rows are one contiguous run, moved as float4s.
template <int ROW>
__device__ __forceinline__ void load_rows(const float* __restrict__ shs, int k, int64_t g0,
                                          int rows, bool vec, float* tile) {
    const int total = rows * ROW;
    if (vec) {
        const float* src = shs + g0 * ROW;
        const int nvec = total / 4;
        for (int i = threadIdx.x; i < nvec; i += kThreads) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
            const int f = 4 * i;
            tile[f + f / ROW] = v.x;
            tile[f + 1 + (f + 1) / ROW] = v.y;
            tile[f + 2 + (f + 2) / ROW] = v.z;
            tile[f + 3 + (f + 3) / ROW] = v.w;
        }
        for (int f = 4 * nvec + threadIdx.x; f < total; f += kThreads) tile[f + f / ROW] = src[f];
    } else {
        const int64_t stride = 3 * static_cast<int64_t>(k);
        for (int f = threadIdx.x; f < total; f += kThreads) {
            const int r = f / ROW;
            tile[f + r] = __ldg(shs + (g0 + r) * stride + (f - r * ROW));
        }
    }
}

template <int ROW>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int k, int64_t g0, int rows,
                                           bool vec, const float* tile) {
    if (vec) {
        float* out = dst + g0 * ROW;
        const int total = rows * ROW;
        const int nvec = total / 4;
        for (int i = threadIdx.x; i < nvec; i += kThreads) {
            const int f = 4 * i;
            reinterpret_cast<float4*>(out)[i] = make_float4(
                tile[f + f / ROW], tile[f + 1 + (f + 1) / ROW], tile[f + 2 + (f + 2) / ROW],
                tile[f + 3 + (f + 3) / ROW]);
        }
        for (int f = 4 * nvec + threadIdx.x; f < total; f += kThreads) out[f] = tile[f + f / ROW];
    } else {  // all 3K entries of each row, zeros past the degree's
        const int out_row = 3 * k;
        const int total = rows * out_row;
        float* out = dst + g0 * out_row;
        for (int f = threadIdx.x; f < total; f += kThreads) {
            const int r = f / out_row, j = f - r * out_row;
            out[f] = j < ROW ? tile[r * (ROW + 1) + j] : 0.0f;
        }
    }
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
sh_color_fwd_kernel(const float* __restrict__ shs, int k, const float* __restrict__ means,
                    const float* __restrict__ center, int64_t n, bool vec,
                    float* __restrict__ colors) {
    constexpr int D = (DEG + 1) * (DEG + 1), ROW = 3 * D;
    __shared__ float tile[kThreads * (ROW + 1)];
    const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads;
    const int rows = static_cast<int>(n - g0 < kThreads ? n - g0 : kThreads);
    load_rows<ROW>(shs, k, g0, rows, vec, tile);
    __syncthreads();
    const int t = threadIdx.x;
    if (t >= rows) return;
    const int64_t g = g0 + t;
    float b[D], color[3];
    sh_basis<DEG>(means[3 * g] - center[0], means[3 * g + 1] - center[1],
                  means[3 * g + 2] - center[2], b);
    sh_color_row<DEG>(b, tile + t * (ROW + 1), color);
    for (int ch = 0; ch < 3; ++ch) colors[3 * g + ch] = color[ch];
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
sh_color_bwd_kernel(const float* __restrict__ shs, int k, const float* __restrict__ means,
                    const float* __restrict__ center, const float* __restrict__ d_colors,
                    int64_t d_colors_stride, int64_t n, bool vec, float* __restrict__ d_shs,
                    float* __restrict__ d_means) {
    constexpr int D = (DEG + 1) * (DEG + 1), ROW = 3 * D;
    __shared__ float tile[kThreads * (ROW + 1)];
    const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads;
    const int rows = static_cast<int>(n - g0 < kThreads ? n - g0 : kThreads);
    load_rows<ROW>(shs, k, g0, rows, vec, tile);
    __syncthreads();
    const int t = threadIdx.x;
    if (t < rows) {
        const int64_t g = g0 + t;
        const float x = means[3 * g] - center[0], y = means[3 * g + 1] - center[1];
        const float z = means[3 * g + 2] - center[2];
        float b[D], d_dir[3];
        sh_basis<DEG>(x, y, z, b);
        const float* gc = d_colors + g * d_colors_stride;
        const float d_color[3] = {gc[0], gc[1], gc[2]};
        sh_color_grad<DEG>(x, y, z, b, tile + t * (ROW + 1), d_color, d_dir);
        for (int r = 0; r < 3; ++r) d_means[3 * g + r] = d_dir[r];
    }
    __syncthreads();
    store_rows<ROW>(d_shs, k, g0, rows, vec, tile);
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

bool rows_vectorised(const float* shs, int k, int degree) {
    return k == (degree + 1) * (degree + 1) && reinterpret_cast<uintptr_t>(shs) % 16 == 0;
}

// launch(std::integral_constant<int, degree>) for degree 0-4; the launch's
// error code.
template <typename Launch>
int with_degree(int degree, int64_t n, Launch launch) {
    if (n <= 0) return 0;
    switch (degree) {
        case 0: launch(std::integral_constant<int, 0>{}); break;
        case 1: launch(std::integral_constant<int, 1>{}); break;
        case 2: launch(std::integral_constant<int, 2>{}); break;
        case 3: launch(std::integral_constant<int, 3>{}); break;
        case 4: launch(std::integral_constant<int, 4>{}); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gsplat_project_fwd(const float* means, const float* scales, const float* quats,
                                  const float* active, int64_t n, const float* view,
                                  const float* proj, const float* fov_x, const float* fov_y,
                                  const float* focal_x, const float* focal_y,
                                  const float* consts, float* means2d, float* depths,
                                  float* cov2d, float* conic, float* radii, float* rect_min,
                                  float* rect_max, void* stream) {
    if (n <= 0) return 0;
    ProjectConsts c;
    std::memcpy(&c, consts, sizeof c);
    project_fwd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        means, scales, quats, active, n, view, proj, CameraScalars{fov_x, fov_y, focal_x, focal_y},
        c, means2d, depths, cov2d, conic, radii, rect_min, rect_max);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int gsplat_project_bwd(const float* means, const float* scales, const float* quats,
                                  const float* active, int64_t n, const float* view,
                                  const float* proj, const float* fov_x, const float* fov_y,
                                  const float* focal_x, const float* focal_y,
                                  const float* consts, const float* g_means2d,
                                  int64_t g_means2d_stride, const float* g_depths,
                                  int64_t g_depths_stride, const float* g_cov2d,
                                  int64_t g_cov2d_stride, const float* g_conic,
                                  int64_t g_conic_stride, float* d_means, float* d_scales,
                                  float* d_quats, void* stream) {
    if (n <= 0) return 0;
    ProjectConsts c;
    std::memcpy(&c, consts, sizeof c);
    project_bwd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        means, scales, quats, active, n, view, proj, CameraScalars{fov_x, fov_y, focal_x, focal_y},
        c,
        Cotangents{g_means2d, g_depths, g_cov2d, g_conic, g_means2d_stride, g_depths_stride,
                   g_cov2d_stride, g_conic_stride},
        d_means, d_scales, d_quats);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int gsplat_sh_color_fwd(const float* shs, int32_t k, int32_t degree,
                                   const float* means, const float* center, int64_t n,
                                   float* colors, void* stream) {
    const bool vec = rows_vectorised(shs, k, degree);
    return with_degree(degree, n, [&](auto deg) {
        sh_color_fwd_kernel<decltype(deg)::value><<<blocks_for(n), kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
            shs, k, means, center, n, vec, colors);
    });
}

extern "C" int gsplat_sh_color_bwd(const float* shs, int32_t k, int32_t degree,
                                   const float* means, const float* center,
                                   const float* d_colors, int64_t d_colors_stride, int64_t n,
                                   float* d_shs, float* d_means, void* stream) {
    const bool vec = rows_vectorised(shs, k, degree);
    return with_degree(degree, n, [&](auto deg) {
        sh_color_bwd_kernel<decltype(deg)::value><<<blocks_for(n), kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
            shs, k, means, center, d_colors, d_colors_stride, n, vec, d_shs, d_means);
    });
}
