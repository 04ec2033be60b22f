// The whole MPF optimize loop for the pendulum dynamics posterior: n_steps
// SVGD iterations on m (length, mass) particles in one launch.
//
// Replaces the TPU kernel `fused_pendulum_mpf_optimize`
// (dust_tpu/ops/pallas_mpf.py, `_mpf_kernel`).
//
// Each iteration, for every particle row i:
//   * GMM prior score over the fixed centers with an isotropic bandwidth
//     (max-subtracted softmax over the centers);
//   * the hand-derived gradient of the Gaussian observation likelihood
//     through one pendulum step, with the speed-clip gate and the
//     log-space chain rule;
//   * the RBF Stein direction in its folded drive form
//     phi_i = (sum_j k_ij (s_j - x_j/bw^2) + (sum_j k_ij) x_i/bw^2) / m;
//   * SGD: x_i += lr * phi_i.
//
// Bound on this card: at the main-path shapes (m = 50, 20 steps) the
// kernel moves ~1.2 KB and does ~1.4 MFLOP, far below a microsecond of
// either; it is bound by the latency of its 20 dependent iterations, each
// a pass over m centers and m particles plus three block barriers.
// Design: one block of ceil(m/32)*32 threads (m <= 1024), one thread per
// particle row; particles, centers and the per-row drive terms live in
// shared memory for the whole loop, so nothing returns to device memory
// between iterations. The arithmetic follows the plain PyTorch version
// operation by operation (built with --fmad=false, expf/sinf at full
// precision); only the order of the sums over j differs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kPi = 3.14159265358979323846f;

__global__ void pendulum_mpf_kernel(const float* __restrict__ x_in,
                                    const float* __restrict__ centers,
                                    const float* __restrict__ scal,
                                    float* __restrict__ x_out, int m,
                                    int n_steps, float dt, float half3g,
                                    int log_space) {
  extern __shared__ float sh[];
  float* sx0 = sh;          // particles, column 0 (length)
  float* sx1 = sh + m;      // particles, column 1 (mass)
  float* sc0 = sh + 2 * m;  // prior centers
  float* sc1 = sh + 3 * m;
  float* st0 = sh + 4 * m;  // drive terms s_j - x_j / bw^2
  float* st1 = sh + 5 * m;

  const int i = threadIdx.x;
  const bool row = i < m;
  if (row) {
    sx0[i] = x_in[2 * i];
    sx1[i] = x_in[2 * i + 1];
    sc0[i] = centers[2 * i];
    sc1[i] = centers[2 * i + 1];
  }
  // scal: [bw, prior_bw, lr, sigma, theta0, theta_d0, action, loc0, loc1]
  const float bw = scal[0];
  const float pbw = scal[1];
  const float lr = scal[2];
  const float sigma = scal[3];
  const float theta0 = scal[4];
  const float theta_d0 = scal[5];
  const float action = scal[6];
  const float loc0 = scal[7];
  const float loc1 = scal[8];

  const float inv_pbw2 = 1.0f / (pbw * pbw);
  const float inv_bw2 = 1.0f / (bw * bw);
  const float inv_s2 = 1.0f / (sigma * sigma);
  const float acts = fminf(fmaxf(action, -kMaxTorque), kMaxTorque);
  const float sin_t = sinf(theta0 + kPi);
  const float fm = static_cast<float>(m);
  __syncthreads();

  for (int it = 0; it < n_steps; ++it) {
    float x0 = 0.0f, x1 = 0.0f;
    if (row) {
      x0 = sx0[i];
      x1 = sx1[i];
      float length = x0;
      float mass = x1;
      if (log_space) {
        length = expf(length);
        mass = expf(mass);
      }
      // ---- likelihood gradient (hand-derived pendulum physics) ----
      const float il = 1.0f / length;
      const float im = 1.0f / mass;
      const float tdd = (-half3g) * il * sin_t + 3.0f * im * il * il * acts;
      const float theta_d_raw = theta_d0 + dt * tdd;
      const float theta_d = fminf(fmaxf(theta_d_raw, -kMaxSpeed), kMaxSpeed);
      const float theta = theta0 + theta_d * dt;
      const float gate =
          (theta_d_raw > -kMaxSpeed && theta_d_raw < kMaxSpeed) ? 1.0f : 0.0f;
      const float dtd_dl =
          gate * dt *
          (half3g * il * il * sin_t - 6.0f * im * il * il * il * acts);
      const float dtd_dm = gate * dt * (-3.0f * im * im * il * il * acts);
      const float r0 = theta - loc0;
      const float r1 = theta_d - loc1;
      const float common = -(r0 * dt + r1) * inv_s2;
      float gl_l = common * dtd_dl;
      float gl_m = common * dtd_dm;
      if (log_space) {
        gl_l = gl_l * length;
        gl_m = gl_m * mass;
      }
      // ---- GMM prior score over the fixed centers ----
      float mx = -INFINITY;
      for (int j = 0; j < m; ++j) {
        const float d0 = x0 - sc0[j];
        const float d1 = x1 - sc1[j];
        mx = fmaxf(mx, -0.5f * (d0 * d0 + d1 * d1) * inv_pbw2);
      }
      float psum = 0.0f, pc0 = 0.0f, pc1 = 0.0f;
      for (int j = 0; j < m; ++j) {
        const float d0 = x0 - sc0[j];
        const float d1 = x1 - sc1[j];
        const float p = expf(-0.5f * (d0 * d0 + d1 * d1) * inv_pbw2 - mx);
        psum = psum + p;
        pc0 = pc0 + p * sc0[j];
        pc1 = pc1 + p * sc1[j];
      }
      const float gp0 = (pc0 / psum - x0) * inv_pbw2;
      const float gp1 = (pc1 / psum - x1) * inv_pbw2;
      st0[i] = (gl_l + gp0) - x0 * inv_bw2;
      st1[i] = (gl_m + gp1) - x1 * inv_bw2;
    }
    __syncthreads();

    float nx0 = 0.0f, nx1 = 0.0f;
    if (row) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      float rows = 0.0f, drive0 = 0.0f, drive1 = 0.0f;
      for (int j = 0; j < m; ++j) {
        const float d0 = x0 - sx0[j];
        const float d1 = x1 - sx1[j];
        const float k = expf(-0.5f * (d0 * d0 + d1 * d1) * inv_bw2);
        rows = rows + k;
        drive0 = drive0 + k * st0[j];
        drive1 = drive1 + k * st1[j];
      }
      const float phi0 = (drive0 + rows * x0 * inv_bw2) / fm;
      const float phi1 = (drive1 + rows * x1 * inv_bw2) / fm;
      nx0 = x0 + lr * phi0;
      nx1 = x1 + lr * phi1;
    }
    __syncthreads();  // every row has read sx before any row writes it
    if (row) {
      sx0[i] = nx0;
      sx1[i] = nx1;
    }
    __syncthreads();
  }
  if (row) {
    x_out[2 * i] = sx0[i];
    x_out[2 * i + 1] = sx1[i];
  }
}

}  // namespace

// x, centers, x_out [m, 2]; scal [9] (see the kernel). All device
// pointers, float32, contiguous; 1 <= m <= 1024. half3g = 3 g 0.5.
extern "C" int dust_pendulum_mpf_optimize(const float* x, const float* centers,
                                          const float* scal, float* x_out,
                                          int m, int n_steps, float dt,
                                          float half3g, int log_space,
                                          void* stream) {
  const int threads = ((m + 31) / 32) * 32;
  const size_t shmem = 6 * static_cast<size_t>(m) * sizeof(float);
  pendulum_mpf_kernel<<<1, threads, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, centers, scal, x_out, m, n_steps, dt, half3g, log_space);
  return static_cast<int>(cudaGetLastError());
}
