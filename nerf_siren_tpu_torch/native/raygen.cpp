// Native host-side data path: ray generation, NDC warp, RGBA blending.
//
// The port's copy of nerf_siren_tpu/native/raygen.cpp, the same code. The
// device runs the renderer; this library covers the HOST hot loops of
// dataset loading (the reference precomputes every ray of every image into
// RAM, reference datasets/blender.py:44-74 / llff.py:217-252: minutes of
// numpy time at 800² x hundreds of images). Built on demand by
// nerf_siren_tpu_torch.native with g++ and bound via ctypes.
//
// All buffers are float32, C-contiguous, caller-allocated.

#include <cmath>
#include <cstdint>

extern "C" {

// Per-pixel camera-space directions: dir = [(i - W/2)/f, -(j - H/2)/f, -1]
// (reference datasets/ray_utils.py:5-24 — no half-pixel centering).
void ray_directions(int H, int W, float focal, float* out /* H*W*3 */) {
    const float cx = W / 2.0f, cy = H / 2.0f;
    for (int j = 0; j < H; ++j) {
        for (int i = 0; i < W; ++i) {
            float* o = out + (static_cast<int64_t>(j) * W + i) * 3;
            o[0] = (i - cx) / focal;
            o[1] = -(j - cy) / focal;
            o[2] = -1.0f;
        }
    }
}

// World rays for one camera: rotate directions by c2w[:, :3], L2-normalize,
// broadcast the origin (reference datasets/ray_utils.py:27-50).
void world_rays(const float* dirs /* N*3 */, const float* c2w /* 3*4 */,
                int64_t n, float* rays_o /* N*3 */, float* rays_d /* N*3 */) {
    const float r00 = c2w[0], r01 = c2w[1], r02 = c2w[2], tx = c2w[3];
    const float r10 = c2w[4], r11 = c2w[5], r12 = c2w[6], ty = c2w[7];
    const float r20 = c2w[8], r21 = c2w[9], r22 = c2w[10], tz = c2w[11];
    for (int64_t k = 0; k < n; ++k) {
        const float* d = dirs + k * 3;
        float wx = d[0] * r00 + d[1] * r01 + d[2] * r02;
        float wy = d[0] * r10 + d[1] * r11 + d[2] * r12;
        float wz = d[0] * r20 + d[1] * r21 + d[2] * r22;
        float inv = 1.0f / std::sqrt(wx * wx + wy * wy + wz * wz);
        rays_d[k * 3 + 0] = wx * inv;
        rays_d[k * 3 + 1] = wy * inv;
        rays_d[k * 3 + 2] = wz * inv;
        rays_o[k * 3 + 0] = tx;
        rays_o[k * 3 + 1] = ty;
        rays_o[k * 3 + 2] = tz;
    }
}

// NDC warp for forward-facing scenes (reference datasets/ray_utils.py:53-93).
void ndc_rays(int H, int W, float focal, float near, int64_t n,
              float* rays_o /* N*3, in-place */, float* rays_d /* N*3 */) {
    const float sx = -1.0f / (W / (2.0f * focal));
    const float sy = -1.0f / (H / (2.0f * focal));
    for (int64_t k = 0; k < n; ++k) {
        float* o = rays_o + k * 3;
        float* d = rays_d + k * 3;
        float t = -(near + o[2]) / d[2];
        o[0] += t * d[0];
        o[1] += t * d[1];
        o[2] += t * d[2];
        float ox_oz = o[0] / o[2], oy_oz = o[1] / o[2];
        float o0 = sx * ox_oz;
        float o1 = sy * oy_oz;
        float o2 = 1.0f + 2.0f * near / o[2];
        float d0 = sx * (d[0] / d[2] - ox_oz);
        float d1 = sy * (d[1] / d[2] - oy_oz);
        o[0] = o0; o[1] = o1; o[2] = o2;
        d[0] = d0; d[1] = d1; d[2] = 1.0f - o2;
    }
}

// RGBA (0..255 uint8) → white-blended RGB float (reference blender.py:61).
void blend_rgba_white(const uint8_t* rgba, int64_t n, float* rgb_out) {
    const float inv = 1.0f / 255.0f;
    for (int64_t k = 0; k < n; ++k) {
        float a = rgba[k * 4 + 3] * inv;
        for (int c = 0; c < 3; ++c) {
            float v = rgba[k * 4 + c] * inv;
            rgb_out[k * 3 + c] = v * a + (1.0f - a);
        }
    }
}

// Pack [o | d | near | far] into the (N, 8) buffer the renderer consumes.
void pack_rays(const float* rays_o, const float* rays_d, float near, float far,
               int64_t n, float* out /* N*8 */) {
    for (int64_t k = 0; k < n; ++k) {
        float* r = out + k * 8;
        for (int c = 0; c < 3; ++c) r[c] = rays_o[k * 3 + c];
        for (int c = 0; c < 3; ++c) r[3 + c] = rays_d[k * 3 + c];
        r[6] = near;
        r[7] = far;
    }
}

}  // extern "C"
