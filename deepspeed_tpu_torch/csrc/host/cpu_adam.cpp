// Host-side vectorized Adam/AdamW for offloaded optimizer states (ZeRO-Offload).
// The port's own copy of the JAX package's csrc/adam/cpu_adam.cpp, the same
// code and C ABI (ds_adam_update, ds_adam_update_copy_bf16, ds_adagrad_update),
// so that built with the same flags it gives the same bits. It updates fp32
// master params + moments resident in host RAM while the GPU computes the
// gradients; deepspeed_tpu_torch/ops/op_builder.py builds it with g++ and
// loads it with ctypes.
//
// AVX2 (+FMA) fast path with scalar tail; scalar fallback elsewhere. A
// span of at least 2 * kMinPerThread elements is split across threads
// (unlike the JAX package's one core) at multiples of 8 elements, so that
// each element takes the same vector or scalar path, and the same bits, as
// in one pass.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// Elements a thread takes at the least: smaller spans stay on one core.
constexpr int64_t kMinPerThread = int64_t(1) << 20;

void adam_span(float* __restrict p,
               const float* __restrict g,
               float* __restrict m,
               float* __restrict v,
               int64_t n,
               int32_t step,
               float lr,
               float beta1,
               float beta2,
               float eps,
               float weight_decay,
               int32_t adamw,
               int32_t bias_correction) {
    float bc1 = 1.0f, bc2 = 1.0f;
    if (bias_correction) {
        bc1 = 1.0f - std::pow(beta1, (float)step);
        bc2 = 1.0f - std::pow(beta2, (float)step);
    }
    const float step_size = lr / bc1;
    const float bc2_sqrt = std::sqrt(bc2);
    const float omb1 = 1.0f - beta1;
    const float omb2 = 1.0f - beta2;

    int64_t i = 0;
#if defined(__AVX2__) && defined(__FMA__)
    const __m256 vb1 = _mm256_set1_ps(beta1);
    const __m256 vb2 = _mm256_set1_ps(beta2);
    const __m256 vomb1 = _mm256_set1_ps(omb1);
    const __m256 vomb2 = _mm256_set1_ps(omb2);
    const __m256 veps = _mm256_set1_ps(eps);
    const __m256 vstep = _mm256_set1_ps(step_size);
    const __m256 vbc2s = _mm256_set1_ps(bc2_sqrt);
    const __m256 vwd = _mm256_set1_ps(weight_decay);
    const __m256 vlrwd = _mm256_set1_ps(lr * weight_decay);
    for (; i + 8 <= n; i += 8) {
        __m256 gp = _mm256_loadu_ps(g + i);
        __m256 pp = _mm256_loadu_ps(p + i);
        if (weight_decay != 0.0f && !adamw) gp = _mm256_fmadd_ps(vwd, pp, gp);
        __m256 mp = _mm256_loadu_ps(m + i);
        __m256 vp = _mm256_loadu_ps(v + i);
        mp = _mm256_fmadd_ps(vb1, mp, _mm256_mul_ps(vomb1, gp));
        vp = _mm256_fmadd_ps(vb2, vp, _mm256_mul_ps(vomb2, _mm256_mul_ps(gp, gp)));
        __m256 denom = _mm256_add_ps(_mm256_div_ps(_mm256_sqrt_ps(vp), vbc2s), veps);
        __m256 update = _mm256_div_ps(mp, denom);
        if (weight_decay != 0.0f && adamw) pp = _mm256_fnmadd_ps(vlrwd, pp, pp);
        pp = _mm256_fnmadd_ps(vstep, update, pp);
        _mm256_storeu_ps(p + i, pp);
        _mm256_storeu_ps(m + i, mp);
        _mm256_storeu_ps(v + i, vp);
    }
#endif
    for (; i < n; ++i) {
        float gi = g[i];
        if (weight_decay != 0.0f && !adamw) gi += weight_decay * p[i];
        m[i] = beta1 * m[i] + omb1 * gi;
        v[i] = beta2 * v[i] + omb2 * gi * gi;
        float denom = std::sqrt(v[i]) / bc2_sqrt + eps;
        if (weight_decay != 0.0f && adamw) p[i] -= lr * weight_decay * p[i];
        p[i] -= step_size * (m[i] / denom);
    }
}

}  // namespace

extern "C" {

// One fused Adam step over a contiguous span.
//   p, g, m, v : fp32 arrays of length n (updated in place except g)
//   step       : 1-based optimizer step (for bias correction)
//   adamw      : 1 → decoupled weight decay (AdamW), 0 → L2-into-grad (Adam)
void ds_adam_update(float* __restrict p,
                    const float* __restrict g,
                    float* __restrict m,
                    float* __restrict v,
                    int64_t n,
                    int32_t step,
                    float lr,
                    float beta1,
                    float beta2,
                    float eps,
                    float weight_decay,
                    int32_t adamw,
                    int32_t bias_correction) {
    const int64_t cores = std::max<int64_t>(1, std::thread::hardware_concurrency());
    const int64_t n_threads = std::min(cores, n / kMinPerThread);
    if (n_threads < 2) {
        adam_span(p, g, m, v, n, step, lr, beta1, beta2, eps, weight_decay, adamw,
                  bias_correction);
        return;
    }
    // chunks of a multiple of 8 elements: only the last one has a scalar tail
    const int64_t chunk = ((n + n_threads - 1) / n_threads + 7) / 8 * 8;
    std::vector<std::thread> workers;
    for (int64_t start = chunk; start < n; start += chunk) {
        const int64_t len = std::min(chunk, n - start);
        workers.emplace_back(adam_span, p + start, g + start, m + start, v + start, len, step,
                             lr, beta1, beta2, eps, weight_decay, adamw, bias_correction);
    }
    adam_span(p, g, m, v, std::min(chunk, n), step, lr, beta1, beta2, eps, weight_decay, adamw,
              bias_correction);
    for (auto& w : workers) w.join();
}

// Update + copy params out as bfloat16 (round-to-nearest-even), saving the
// separate cast pass when the device copy is bf16
// (reference adam_update_copy, cpu_adam.cpp:303).
void ds_adam_update_copy_bf16(float* __restrict p,
                              const float* __restrict g,
                              float* __restrict m,
                              float* __restrict v,
                              uint16_t* __restrict p_bf16,
                              int64_t n,
                              int32_t step,
                              float lr,
                              float beta1,
                              float beta2,
                              float eps,
                              float weight_decay,
                              int32_t adamw,
                              int32_t bias_correction) {
    ds_adam_update(p, g, m, v, n, step, lr, beta1, beta2, eps, weight_decay, adamw, bias_correction);
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        std::memcpy(&bits, p + i, 4);
        uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
        p_bf16[i] = (uint16_t)((bits + rounding) >> 16);
    }
}

// Vectorized Adagrad (reference csrc/adagrad/cpu_adagrad.cpp).
void ds_adagrad_update(float* __restrict p,
                       const float* __restrict g,
                       float* __restrict h,
                       int64_t n,
                       float lr,
                       float eps,
                       float weight_decay) {
    for (int64_t i = 0; i < n; ++i) {
        float gi = g[i] + weight_decay * p[i];
        h[i] += gi * gi;
        p[i] -= lr * gi / (std::sqrt(h[i]) + eps);
    }
}

}  // extern "C"
