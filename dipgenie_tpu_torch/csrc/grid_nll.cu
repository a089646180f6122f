// K12: the fitter's float32 grid NLL, and the small tables it reads, as
// two kernels of one source. Together they replace the XLA function
// dipgenie_tpu/models/fitter.py `_grid_nll_jax`.
//
// grid_tables_kernel (`_grid_nll_jax` :201-233, one launch): the tables
//
//   fhom[u, sd, zp, x]  = max(sum_c zeta(ZP[zp])[c] * pdf(x; U[u] c,
//                                     SD[sd] sqrt(c)), 1e-35)
//   fhet[u, vw, zph, x] = max(sum_c zeta(ZPH[zph])[c] * pdf(x; U[u] c / 2,
//                                     sqrt(max(VW[vw], 1e-12)) sqrt(c) / 2),
//                             1e-35)
//   ferr[s, x]          = x^-SS[s] - (x + 1)^-SS[s], floored at 1e-35
//
// over the copies c = 1 .. max_copy, with zeta(z)[c] = c^-z / sum_c c^-z
// and pdf(x; mu, sd) = inv_s2pi / sd * exp(-z^2 / 2), z = (x - mu) / sd,
// in float32 in the plain version's order of operations. Every block
// builds the zeta weights of ZP and ZPH in shared memory; then a thread
// owns one table entry and sums over the copies itself. It is tiny work
// (~10^4 entries at the default grid): the kernel sits at the launch
// floor and is there to replace the ~40 small launches and 10 copies of
// the plain version.
//
// grid_nll_kernel (the `lax.map` body `one`, :235-256): for every grid
// point (u, sd, vw, zp, zph, pd, pe, s), over the histogram's bins x,
//
//   nll = -sum_x y[x] * log(pe * ferr[s, x] + (1 - pe) * pd * fhet[u, vw,
//         zph, x] + (1 - pe) * (1 - pd) * fhom[u, sd, zp, x] + 1e-35)
//
// in float32, with JAX's order of operations (each step rounded, no fused
// multiply-adds) and the full-precision logf, written in the loop order
// [u, sd, vw, zp, zph, pd, pe, s]. The caller ranks the points and
// re-evaluates the best in float64, so only the ranking near the minimum
// matters.
//
// What bounds it on the H100: one log a (point, bin); the output (4 bytes
// a point) and the tables (a few KB, L1-resident) are small beside it, so
// the kernel is bound by its instructions, most of them the log's. Design:
// the outer index o = (u, sd, vw, zp, zph) picks the two table rows; a
// thread owns one o, one (pe, s) and P consecutive pd values, so its P
// points share every load of a bin (the fhom and fhet entries, pe *
// ferr[s, x] and y[x]: one each a bin for all P) and run P independent
// log chains that interleave. Consecutive threads take consecutive (pe,
// s) of the same o, so each of the P stores is coalesced. A thread's
// indices come from its slot number by 32-bit multiply-shift division
// with constants the wrapper computes (models/fitter.py
// grid_nll_geometry), never a 64-bit division. The tables are read
// through the read-only cache: staging them in shared memory would bound
// the grid by shared memory and saves nothing on L1-resident rows.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float INV_S2PI = 0.3989422804014327f;

// n / d == (n * mul) >> shift for 0 <= n < 2^31 (models/fitter.py:divider)
struct Div {
  uint32_t d, mul, shift;
};

__device__ __forceinline__ uint32_t quo(uint32_t n, Div v) {
  return (uint32_t)(((uint64_t)n * v.mul) >> v.shift);
}

// The launch geometry, in the order of models/fitter.py:grid_nll_geometry.
struct Geometry {
  uint32_t p, slots, blocks, npd, nx;
  Div per_outer, nps, ns, nzph, nzp, nvw, nsd;
};
constexpr int GEOMETRY_WORDS = 5 + 7 * 3;
static_assert(sizeof(Geometry) == GEOMETRY_WORDS * 4, "Geometry layout");

template <int P>
__global__ void __launch_bounds__(THREADS)
grid_nll_kernel(const float* __restrict__ fhom, const float* __restrict__ fhet,
                const float* __restrict__ ferr, const float* __restrict__ pds,
                const float* __restrict__ pes, const float* __restrict__ y,
                const Geometry g, float* __restrict__ out) {
  const uint32_t slot = blockIdx.x * THREADS + threadIdx.x;
  if (slot >= g.slots) return;
  // slot = o * per_outer + chunk * nps + ps; ps = ipe * ns + is
  const uint32_t o = quo(slot, g.per_outer);
  const uint32_t r = slot - o * g.per_outer.d;
  const uint32_t chunk = quo(r, g.nps);
  const uint32_t ps = r - chunk * g.nps.d;
  const uint32_t ipe = quo(ps, g.ns);
  const uint32_t is = ps - ipe * g.ns.d;
  // o = (((u * nsd + sd) * nvw + vw) * nzp + zp) * nzph + zph
  uint32_t t = quo(o, g.nzph);
  const uint32_t izph = o - t * g.nzph.d;
  uint32_t t2 = quo(t, g.nzp);
  const uint32_t izp = t - t2 * g.nzp.d;
  t = quo(t2, g.nvw);
  const uint32_t ivw = t2 - t * g.nvw.d;
  const uint32_t iu = quo(t, g.nsd);
  const uint32_t isd = t - iu * g.nsd.d;

  const int nx = (int)g.nx;
  const float* hom = fhom + (size_t)((iu * g.nsd.d + isd) * g.nzp.d + izp) * nx;
  const float* het = fhet + (size_t)((iu * g.nvw.d + ivw) * g.nzph.d + izph) * nx;
  const float* err = ferr + (size_t)is * nx;
  const float pe = __ldg(pes + ipe);
  const float q = __fsub_rn(1.0f, pe);
  const uint32_t pd0 = chunk * P;
  float wb[P], wc[P], acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    // a pd past the axis (the last chunk's) repeats the last; not stored
    const float pd = __ldg(pds + min(pd0 + j, g.npd - 1));
    wb[j] = __fmul_rn(q, pd);
    wc[j] = __fmul_rn(q, __fsub_rn(1.0f, pd));
    acc[j] = 0.0f;
  }
  for (int x = 0; x < nx; ++x) {
    const float h = __ldg(hom + x), b = __ldg(het + x), yx = __ldg(y + x);
    const float e = __fmul_rn(pe, __ldg(err + x));
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float mix = __fadd_rn(__fadd_rn(e, __fmul_rn(wb[j], b)),
                                  __fmul_rn(wc[j], h));
      acc[j] = __fadd_rn(acc[j], __fmul_rn(logf(__fadd_rn(mix, 1e-35f)), yx));
    }
  }
  const uint32_t nps = g.nps.d;
  float* dst = out + ((size_t)o * g.npd + pd0) * nps + ps;
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (pd0 + j < g.npd) dst[(size_t)j * nps] = -acc[j];
}

struct TableDims {
  int u, sd, vw, zp, zph, s, x, copies;
};

__device__ __forceinline__ float pdf(float x, float mu, float sdc) {
  // the plain version's (x - mu) / sdc, then reciprocal(sdc) * inv_s2pi *
  // exp((-0.5 * z) * z)
  const float z = __fdiv_rn(__fsub_rn(x, mu), sdc);
  return __fmul_rn(__fmul_rn(__frcp_rn(sdc), INV_S2PI),
                   expf(__fmul_rn(__fmul_rn(-0.5f, z), z)));
}

__global__ void __launch_bounds__(THREADS)
grid_tables_kernel(const float* __restrict__ U, const float* __restrict__ SD,
                   const float* __restrict__ VW, const float* __restrict__ ZP,
                   const float* __restrict__ ZPH, const float* __restrict__ SS,
                   const float* __restrict__ X, const TableDims n,
                   float* __restrict__ fhom, float* __restrict__ fhet,
                   float* __restrict__ ferr) {
  // zeta weights [zp + zph, copies], then each row's sum
  extern __shared__ float zw[];
  const int C = n.copies, rows = n.zp + n.zph;
  float* sums = zw + rows * C;
  for (int i = threadIdx.x; i < rows * C; i += THREADS) {
    const int row = i / C;
    const float z = row < n.zp ? ZP[row] : ZPH[row - n.zp];
    zw[i] = __frcp_rn(powf((float)(i - row * C + 1), z));
  }
  __syncthreads();
  for (int row = threadIdx.x; row < rows; row += THREADS) {
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s = __fadd_rn(s, zw[row * C + c]);
    sums[row] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * C; i += THREADS)
    zw[i] = __fdiv_rn(zw[i], sums[i / C]);
  __syncthreads();

  const int n_hom = n.u * n.sd * n.zp * n.x;
  const int n_het = n.u * n.vw * n.zph * n.x;
  int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n_hom + n_het + n.s * n.x) return;
  if (e >= n_hom + n_het) {  // ferr [s, x]
    e -= n_hom + n_het;
    const float x = X[e % n.x], s = SS[e / n.x];
    const float f = __fsub_rn(powf(x, -s), powf(__fadd_rn(x, 1.0f), -s));
    ferr[e] = f > 0.0f ? f : 1e-35f;
    return;
  }
  const bool het = e >= n_hom;
  const int k = het ? e - n_hom : e;
  // k = ((u * n2 + i2) * nz + iz) * nx + ix: (i2, iz) = (sd, zp) or (vw, zph)
  const int nz = het ? n.zph : n.zp, n2 = het ? n.vw : n.sd;
  const int ix = k % n.x, iz = (k / n.x) % nz, i2 = (k / (n.x * nz)) % n2;
  const int iu = k / (n.x * nz * n2);
  const float x = X[ix];
  float mu1, sd1;  // the mean and sd of one copy
  if (het) {
    mu1 = __fmul_rn(0.5f, U[iu]);
    sd1 = __fmul_rn(0.5f, __fsqrt_rn(fmaxf(VW[i2], 1e-12f)));
  } else {
    mu1 = U[iu];
    sd1 = SD[i2];
  }
  const float* w = zw + (het ? n.zp + iz : iz) * C;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float cf = (float)(c + 1);
    acc = fmaf(w[c], pdf(x, __fmul_rn(mu1, cf),
                         __fmul_rn(sd1, __fsqrt_rn(cf))), acc);
  }
  (het ? fhet : fhom)[k] = fmaxf(acc, 1e-35f);
}

template <int P>
cudaError_t launch_nll(const float* fhom, const float* fhet, const float* ferr,
                       const float* pd, const float* pe, const float* y,
                       const Geometry& g, float* out, cudaStream_t stream) {
  grid_nll_kernel<P><<<g.blocks, THREADS, 0, stream>>>(fhom, fhet, ferr, pd,
                                                        pe, y, g, out);
  return cudaGetLastError();
}

}  // namespace

// fhom [u, sd, zp, x], fhet [u, vw, zph, x], ferr [s, x], pd [pd], pe [pe],
// y [x] float32; geometry: GEOMETRY_WORDS uint32 in host memory, from
// models/fitter.py:grid_nll_geometry; out [u, sd, vw, zp, zph, pd, pe, s]
// float32.
extern "C" int dg_grid_nll(const float* fhom, const float* fhet,
                           const float* ferr, const float* pd, const float* pe,
                           const float* y, const uint32_t* geometry,
                           float* out, cudaStream_t stream) {
  Geometry g;
  memcpy(&g, geometry, sizeof g);
  if (g.blocks < 1 || g.slots < 1 || g.slots > 0x7fffffffu ||
      (uint64_t)g.blocks * THREADS < g.slots || g.npd < 1 || g.nx < 1)
    return (int)cudaErrorInvalidValue;
  switch (g.p) {  // points a thread: 1 .. 8 pd values
    case 1: return (int)launch_nll<1>(fhom, fhet, ferr, pd, pe, y, g, out, stream);
    case 2: return (int)launch_nll<2>(fhom, fhet, ferr, pd, pe, y, g, out, stream);
    case 3: return (int)launch_nll<3>(fhom, fhet, ferr, pd, pe, y, g, out, stream);
    case 4: return (int)launch_nll<4>(fhom, fhet, ferr, pd, pe, y, g, out, stream);
    case 5: return (int)launch_nll<5>(fhom, fhet, ferr, pd, pe, y, g, out, stream);
    case 6: return (int)launch_nll<6>(fhom, fhet, ferr, pd, pe, y, g, out, stream);
    case 7: return (int)launch_nll<7>(fhom, fhet, ferr, pd, pe, y, g, out, stream);
    case 8: return (int)launch_nll<8>(fhom, fhet, ferr, pd, pe, y, g, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The axes U [u], SD [sd], VW [vw], ZP [zp], ZPH [zph], SS [s], xs [x]
// float32; fhom [u, sd, zp, x], fhet [u, vw, zph, x], ferr [s, x] float32.
extern "C" int dg_grid_tables(const float* U, const float* SD, const float* VW,
                              const float* ZP, const float* ZPH,
                              const float* SS, const float* xs, int nu,
                              int nsd, int nvw, int nzp, int nzph, int ns,
                              int nx, int max_copy, float* fhom, float* fhet,
                              float* ferr, cudaStream_t stream) {
  const TableDims n{nu, nsd, nvw, nzp, nzph, ns, nx, max_copy};
  if (nu < 1 || nsd < 1 || nvw < 1 || nzp < 1 || nzph < 1 || ns < 1 ||
      nx < 1 || max_copy < 1)
    return (int)cudaErrorInvalidValue;
  const long long entries = ((long long)nu * nsd * nzp +
                             (long long)nu * nvw * nzph + ns) * nx;
  if (entries > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(nzp + nzph) * (max_copy + 1);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        grid_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const unsigned blocks = (unsigned)((entries + THREADS - 1) / THREADS);
  grid_tables_kernel<<<blocks, THREADS, smem, stream>>>(
      U, SD, VW, ZP, ZPH, SS, xs, n, fhom, fhet, ferr);
  return (int)cudaGetLastError();
}
