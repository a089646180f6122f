// K12: the fitter's float32 mixture NLL at every point of its 8-D grid.
//
// Replaces the `lax.map` body `one` of dipgenie_tpu/models/fitter.py
// `_grid_nll_jax` (an XLA function): for every grid point (u, sd, vw, zp,
// zph, pd, pe, s), over the histogram's bins x,
//
//   nll = -sum_x y[x] * log(pe * ferr[s, x] + (1 - pe) * pd * fhet[u, vw,
//         zph, x] + (1 - pe) * (1 - pd) * fhom[u, sd, zp, x] + 1e-35)
//
// in float32, with JAX's order of operations (no fused multiply-adds) and
// the full-precision logf, written in the loop order [u, sd, vw, zp, zph,
// pd, pe, s]. The small tables fhom, fhet and ferr are built by the caller
// (plain torch, as JAX built them outside its map). The caller ranks the
// points and re-evaluates the best in float64, so only the ranking near
// the minimum matters.
//
// What bounds it on the H100: one log a (point, bin) on the special
// function units; the output (4 bytes a point) and the tables (L1- and
// L2-resident) are small beside it. Design: one thread a grid point, a
// loop over the bins.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Dims {
  int u, sd, vw, zp, zph, pd, pe, s, x;
};

__global__ void __launch_bounds__(THREADS)
grid_nll_kernel(const float* __restrict__ fhom, const float* __restrict__ fhet,
                const float* __restrict__ ferr, const float* __restrict__ pds,
                const float* __restrict__ pes, const float* __restrict__ y,
                Dims n, long long points, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= points) return;
  long long r = idx;
  const int is = (int)(r % n.s); r /= n.s;
  const int ipe = (int)(r % n.pe); r /= n.pe;
  const int ipd = (int)(r % n.pd); r /= n.pd;
  const int izph = (int)(r % n.zph); r /= n.zph;
  const int izp = (int)(r % n.zp); r /= n.zp;
  const int ivw = (int)(r % n.vw); r /= n.vw;
  const int isd = (int)(r % n.sd); r /= n.sd;
  const int iu = (int)r;
  const float pd = pds[ipd], pe = pes[ipe];
  const float q = __fsub_rn(1.0f, pe);
  const float wb = __fmul_rn(q, pd);
  const float wc = __fmul_rn(q, __fsub_rn(1.0f, pd));
  const float* hom = fhom + (((size_t)iu * n.sd + isd) * n.zp + izp) * n.x;
  const float* het = fhet + (((size_t)iu * n.vw + ivw) * n.zph + izph) * n.x;
  const float* err = ferr + (size_t)is * n.x;
  float acc = 0.0f;
  for (int x = 0; x < n.x; ++x) {
    const float mix = __fadd_rn(
        __fadd_rn(__fmul_rn(pe, err[x]), __fmul_rn(wb, het[x])),
        __fmul_rn(wc, hom[x]));
    acc = __fadd_rn(acc, __fmul_rn(logf(__fadd_rn(mix, 1e-35f)), y[x]));
  }
  out[idx] = -acc;
}

}  // namespace

// fhom [u, sd, zp, x], fhet [u, vw, zph, x], ferr [s, x], pd [pd], pe [pe],
// y [x] float32; out [u, sd, vw, zp, zph, pd, pe, s] float32.
extern "C" int dg_grid_nll(const float* fhom, const float* fhet,
                           const float* ferr, const float* pd, const float* pe,
                           const float* y, int nu, int nsd, int nvw, int nzp,
                           int nzph, int npd, int npe, int ns, int nx,
                           float* out, cudaStream_t stream) {
  const Dims n{nu, nsd, nvw, nzp, nzph, npd, npe, ns, nx};
  const long long points = (long long)nu * nsd * nvw * nzp * nzph * npd *
                           npe * ns;
  if (nu < 1 || nsd < 1 || nvw < 1 || nzp < 1 || nzph < 1 || npd < 1 ||
      npe < 1 || ns < 1 || nx < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (points + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grid_nll_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      fhom, fhet, ferr, pd, pe, y, n, points, out);
  return (int)cudaGetLastError();
}
