// Congruent-set dense gate for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel model_matching_tpu/ops/pallas_congruent.py
// (dense_gate -> _gate_kernel), and the XLA path the JAX package takes for
// the dense tiers whose shapes or modes that kernel does not take. For each
// base of a batch it evaluates the [P, Q] gate between the two PPF pair
// lists of the base,
//
//   match(p, q) = cell_p == cell_q
//                 && (!check_cos || |n_p . n_q - alpha| <= tol)
//                 && (skip_dist || (sq_p + sq_q) - 2 (e_p . e_q) <= thr)
//
// packs every match into the positive int32 key
//   ((rp[p] ^ rq[q]) & rand_mask) | marker | q
// and reduces it to the per-row maximum over n_sub contiguous column
// stripes of each Q tile (stripe width q_tile / n_sub; n_sub <= 16),
// merged across Q tiles by max, plus the per-row match count. Invalid lanes
// carry negative cell tags that differ between the P side (-1) and the Q
// side (-2), so they never match; the radius distance mode passes cell 0 on
// every valid lane, so that only the distance test decides.
//
// What bounds it on this card: nothing is read from device memory inside
// the scan, and only same-cell pairs can match, so the work that has to be
// done is the float test on those pairs (1/8 of the [P, Q] pairs on 8
// random cells, fewer on real position cells). A scan that walks all P x Q
// pairs is bound by the schedulers' instruction rate on pairs it throws
// away. The design therefore visits same-cell pairs only, and keeps every
// partial result on chip:
//
// * A block of 512 threads owns R consecutive P rows (a multiple of 16,
//   at most 256, so they lie in at most two 256-row P tiles) for the whole
//   of Q. Its stripe maxima and counts live in shared memory from the first
//   Q tile to the last and are written once with plain stores: no global
//   atomics, and no zero-fill of the outputs by the caller (rows of dead or
//   skipped tiles are written as zero here). Narrow row tiles were chosen
//   over splitting Q across the blocks of a cluster: the launch picks the
//   height at which all blocks are resident at once (one top-tier base,
//   P = 21,760, gives 227 blocks of 96 rows for 264 slots), so no merge
//   step between blocks is needed to fill the card.
// * Q is walked in slabs of at most 2,304 columns (a slab never straddles
//   a Q tile). Each slab is bucketed by cell with a counting sort in shared
//   memory: 128 buckets on an XOR-fold of the three 10-bit fields of the
//   packed cell id; a histogram by shared-memory atomicAdd whose return
//   value is the column's rank in its bucket, a warp scan of the 128
//   counts, then the scatter of the slab's columns into bucket order, each
//   as a 16-byte word {cell, n}, with the distance test a 16-byte word
//   {e, sq}, an 8-byte word {rq & rand_mask, marker | column} and a stripe
//   byte. The order of columns inside a bucket depends on the atomics; max
//   and integer sum do not depend on it, so the result is deterministic
//   and bit-exact all the same. (Ordering a bucket by stripe as well, to
//   keep a stripe's running maximum in registers, was measured slower:
//   position cells leave two or three columns a stripe.)
// * One warp takes one row at a time and walks only the bucket of that
//   row's cell, 32 consecutive columns a step, comparing the full cell id
//   (hash collisions, the negative tags and the single cell of the radius
//   mode all come out right). Every lane's step is a same-bucket pair, the
//   shared-memory reads are consecutive 16-byte words, the tests are
//   evaluated without branches, and lanes do not diverge on list length as
//   one-thread-per-row would. A match goes to the row's stripe maximum
//   with a shared-memory atomicMax (the warp's lanes are the row's only
//   writers); the count is one warp reduction a row and slab.
//
// Shapes: P is any size (the last row tile is partial), Q = n_qt * q_tile
// for any q_tile (a Q tile is cut into equal slabs, the last one shorter).
//
// Skipping: a (P tile, Q tile) pair is not scanned when it is dead in the
// optional `live` mask [B, ceil(P/256), Q/q_tile], or when it lies past
// the tile-granular bound of the valid-lane counts p_count / q_count (read
// on the device; tiles past ceil(count / tile), at least one tile, are
// never evaluated, as the TPU kernel's dynamic grid does).
//
// Arithmetic order is fixed: products rounded one by one, sums left to
// right, d2 = (sq_p + sq_q) - 2 * dot, written with __fmul_rn / __fadd_rn /
// __fsub_rn so that no multiply-add is contracted. The plain torch version
// (ops/dense_gate.py: dense_gate_reference) computes the same expressions
// with separate elementwise ops, and the two agree bit for bit.
//
// Plain C interface (built with nvcc, loaded with ctypes). The launch goes
// to the caller's stream; the function returns the CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlabMax = 2304;  // most Q columns staged at once
constexpr int kColsPerThread = (kSlabMax + kThreads - 1) / kThreads;
constexpr int kBuckets = 128;   // cell-hash buckets
constexpr int kSub = 16;        // most stripes per Q tile
constexpr int kPerLane = kBuckets / 32;  // buckets per lane of the scanning warp
constexpr int kPTile = 256;     // rows per tile of p_count's bound and `live`
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t smem_bytes(bool skip_dist, int rows) {
  // slab columns: 16 bytes {cell, n} (+ 16 bytes {e, sq}), 8 bytes of key
  // parts, one stripe byte; histogram and bucket starts; per row 7
  // features, cell, rp, 16 maxima, count
  return 4 * ((size_t)kSlabMax * (skip_dist ? 6 : 10) + kBuckets + kBuckets + 4 +
              (size_t)rows * (7 + 2 + kSub + 1)) +
         kSlabMax;
}

__device__ __forceinline__ int bucket_of(int cell) {
  const unsigned u = (unsigned)cell;
  return (int)((u ^ (u >> 10) ^ (u >> 20)) & (kBuckets - 1));
}

template <bool kSkipDist, bool kCheckCos>
__global__ void __launch_bounds__(kThreads, 2)
dense_gate_kernel(const float* __restrict__ p_feat,   // [B, 8, P]
                  const float* __restrict__ q_feat,   // [B, 8, Q]
                  const int* __restrict__ p_cell,     // [B, P]
                  const int* __restrict__ q_cell,     // [B, Q]
                  const int* __restrict__ rp,         // [B, P]
                  const int* __restrict__ rq,         // [B, Q]
                  const float* __restrict__ alpha,    // [B]
                  const int* __restrict__ p_count,    // [B]
                  const int* __restrict__ q_count,    // [B]
                  const int* __restrict__ live,       // [B, n_pt, n_qt] or null
                  int* __restrict__ row_best,         // [B, P, n_sub]
                  int* __restrict__ counts,           // [B, P]
                  int P, int Q, int q_tile, int n_sub, int R, float tol,
                  float thr, int rand_mask, int marker) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // a slab's columns in bucket order: {cell, n} and, with the distance
  // test, {e, sq} as one 16-byte word each, {rq & rand_mask, marker | col}
  // as one 8-byte word, the stripe index as a byte
  int4* s_cn = reinterpret_cast<int4*>(smem_raw);           // [kSlabMax]
  float4* s_esq = reinterpret_cast<float4*>(s_cn + kSlabMax);  // [kSlabMax]
  int2* s_key = reinterpret_cast<int2*>(s_esq + (kSkipDist ? 0 : kSlabMax));
  int* s_hist = reinterpret_cast<int*>(s_key + kSlabMax);  // [kBuckets]
  int* s_start = s_hist + kBuckets;                        // [kBuckets + 1]
  float* s_pf = reinterpret_cast<float*>(s_start + kBuckets + 4);  // [7][R]
  int* s_pcell = reinterpret_cast<int*>(s_pf + 7 * R);     // [R]
  int* s_prp = s_pcell + R;                                // [R]
  int* s_best = s_prp + R;                                 // [R][kSub]
  int* s_cnt = s_best + R * kSub;                          // [R]
  unsigned char* s_stripe = reinterpret_cast<unsigned char*>(s_cnt + R);

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, P - r0);
  // the block's rows lie in at most two 256-row P tiles (R <= 256)
  const int ptile0 = r0 / kPTile;
  const int ptile1 = (r0 + nrows - 1) / kPTile;
  const int n_ptiles = (P + kPTile - 1) / kPTile;
  const int n_qtiles = Q / q_tile;

  int pt = (p_count[b] + kPTile - 1) / kPTile;
  pt = min(max(pt, 1), n_ptiles);
  int qt = (q_count[b] + q_tile - 1) / q_tile;
  qt = min(max(qt, 1), n_qtiles);
  if (ptile0 >= pt) qt = 0;

  for (int i = t; i < R * kSub; i += kThreads) s_best[i] = 0;
  for (int i = t; i < kBuckets; i += kThreads) s_hist[i] = 0;
  for (int i = t; i < R; i += kThreads) {
    s_cnt[i] = 0;
    if (i < nrows && qt > 0) {
      const float* pf = p_feat + (size_t)b * 8 * P + r0 + i;
#pragma unroll
      for (int k = 0; k < 7; ++k) s_pf[k * R + i] = pf[(size_t)k * P];
      s_pcell[i] = p_cell[(size_t)b * P + r0 + i];
      s_prp[i] = rp[(size_t)b * P + r0 + i];
    }
  }
  __syncthreads();

  const float a = alpha[b];
  const int w = q_tile / n_sub;
  const int n_slabs = (q_tile + kSlabMax - 1) / kSlabMax;
  const int slab_w = (q_tile + n_slabs - 1) / n_slabs;
  const float* qf = q_feat + (size_t)b * 8 * Q;
  const int* qc = q_cell + (size_t)b * Q;
  const int* qr = rq + (size_t)b * Q;

  for (int j = 0; j < qt; ++j) {
    // which of the block's two P tiles evaluate this Q tile
    bool on0 = true;
    bool on1 = ptile1 < pt;
    if (live != nullptr) {
      on0 = live[((size_t)b * n_ptiles + ptile0) * n_qtiles + j] != 0;
      on1 = on1 && live[((size_t)b * n_ptiles + ptile1) * n_qtiles + j] != 0;
    }
    if (!on0 && !on1) continue;
    for (int sl = 0; sl < n_slabs; ++sl) {
      const int local0 = sl * slab_w;  // within the Q tile
      const int ncols = min(slab_w, q_tile - local0);
      const int c0 = j * q_tile + local0;

      // counting sort, pass 1: the histogram; the old value of the
      // atomicAdd is the column's rank in its bucket
      int cellv[kColsPerThread];
      int rank[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i) {
        const int k = t + i * kThreads;
        cellv[i] = 0;
        rank[i] = 0;
        if (k < ncols) {
          cellv[i] = qc[c0 + k];
          rank[i] = atomicAdd(&s_hist[bucket_of(cellv[i])], 1);
        }
      }
      __syncthreads();
      // exclusive scan of the bucket counts by one warp, kPerLane buckets a
      // lane; the histogram is cleared for the next slab
      if (warp == 0) {
        int v[kPerLane];
        int tot = 0;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          v[i] = s_hist[lane * kPerLane + i];
          s_hist[lane * kPerLane + i] = 0;
          tot += v[i];
        }
        int inc = tot;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int up = __shfl_up_sync(kFull, inc, o);
          if (lane >= o) inc += up;
        }
        int ex = inc - tot;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          s_start[lane * kPerLane + i] = ex;
          ex += v[i];
        }
        if (lane == 31) s_start[kBuckets] = inc;
      }
      __syncthreads();
      // pass 2: scatter the slab's columns into bucket order
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i) {
        const int k = t + i * kThreads;
        if (k < ncols) {
          const int pos = s_start[bucket_of(cellv[i])] + rank[i];
          const int c = c0 + k;
          s_cn[pos] = make_int4(cellv[i], __float_as_int(qf[(size_t)3 * Q + c]),
                                __float_as_int(qf[(size_t)4 * Q + c]),
                                __float_as_int(qf[(size_t)5 * Q + c]));
          if (!kSkipDist) {
            s_esq[pos] = make_float4(qf[c], qf[(size_t)Q + c], qf[(size_t)2 * Q + c],
                                     qf[(size_t)6 * Q + c]);
          }
          s_key[pos] = make_int2(qr[c] & rand_mask, marker | c);
          s_stripe[pos] = (unsigned char)((local0 + k) / w);
        }
      }
      __syncthreads();

      // the scan: one warp per row, over the bucket of the row's cell
      for (int lr = warp; lr < nrows; lr += kWarps) {
        if (!((r0 + lr) / kPTile == ptile0 ? on0 : on1)) continue;
        const int cp = s_pcell[lr];
        const int h = bucket_of(cp);
        const int beg = s_start[h];
        const int end = s_start[h + 1];
        if (beg == end) continue;
        const float ex = s_pf[lr];
        const float ey = s_pf[R + lr];
        const float ez = s_pf[2 * R + lr];
        const float nx = s_pf[3 * R + lr];
        const float ny = s_pf[4 * R + lr];
        const float nz = s_pf[5 * R + lr];
        const float sqp = s_pf[6 * R + lr];
        const int rpm = s_prp[lr] & rand_mask;
        int* best = s_best + lr * kSub;
        int cnt = 0;
        // the tests are evaluated without branches on every column of the
        // bucket, so that the loads of a step do not wait for the compares
        // before them; a match goes straight to the row's stripe maximum
        // (a shared-memory atomic: the lanes of this warp are the only
        // writers of the row, and several may hold the same stripe)
#pragma unroll 2
        for (int k = beg + lane; k < end; k += 32) {
          const int4 cn = s_cn[k];
          bool ok = cn.x == cp;
          if (kCheckCos) {
            const float cosv = __fadd_rn(
                __fadd_rn(__fmul_rn(nx, __int_as_float(cn.y)),
                          __fmul_rn(ny, __int_as_float(cn.z))),
                __fmul_rn(nz, __int_as_float(cn.w)));
            ok = ok && fabsf(__fsub_rn(cosv, a)) <= tol;
          }
          if (!kSkipDist) {
            const float4 q = s_esq[k];
            const float dot = __fadd_rn(
                __fadd_rn(__fmul_rn(ex, q.x), __fmul_rn(ey, q.y)), __fmul_rn(ez, q.z));
            const float d2 = __fsub_rn(__fadd_rn(sqp, q.w), __fmul_rn(2.0f, dot));
            ok = ok && d2 <= thr;
          }
          if (ok) {
            const int2 key = s_key[k];
            atomicMax(best + s_stripe[k], (rpm ^ key.x) | key.y);
            ++cnt;
          }
        }
        const int tot = __reduce_add_sync(kFull, cnt);
        if (lane == 0) s_cnt[lr] += tot;
      }
    }
  }
  __syncthreads();

  int* out = row_best + ((size_t)b * P + r0) * n_sub;
  for (int i = t; i < nrows * n_sub; i += kThreads) {
    const int r = i / n_sub;
    out[i] = s_best[r * kSub + (i - r * n_sub)];
  }
  for (int i = t; i < nrows; i += kThreads) {
    counts[(size_t)b * P + r0 + i] = s_cnt[i];
  }
}

template <bool kSkipDist, bool kCheckCos>
cudaError_t launch(dim3 grid, int rows, cudaStream_t st, const float* p_feat,
                   const float* q_feat, const int* p_cell, const int* q_cell,
                   const int* rp, const int* rq, const float* alpha,
                   const int* p_count, const int* q_count, const int* live,
                   int* row_best, int* counts, int P, int Q, int q_tile,
                   int n_sub, float tol, float thr, int rand_mask, int marker) {
  const size_t smem = smem_bytes(kSkipDist, rows);
  cudaError_t err = cudaFuncSetAttribute(
      dense_gate_kernel<kSkipDist, kCheckCos>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dense_gate_kernel<kSkipDist, kCheckCos><<<grid, kThreads, smem, st>>>(
      p_feat, q_feat, p_cell, q_cell, rp, rq, alpha, p_count, q_count, live,
      row_best, counts, P, Q, q_tile, n_sub, rows, tol, thr, rand_mask, marker);
  return cudaGetLastError();
}

}  // namespace

// The row-tile height (R in the kernel: a multiple of 16, at most 256) is
// the one at which all the blocks are resident at once (two blocks of 512
// threads an SM of the current device), kept between 64 and 128. Wider
// tiles bucket each Q slab fewer times; narrower ones fill the card when
// there are few rows; below 64 and past 128 rows the measured time rose at
// the main path's shapes. A tuning build fixes the height instead with
// -DMM_GATE_ROWS=<rows> (scripts/torch_gate_tune.py --rows).
// mm_dense_gate_rows writes the height a launch of B bases of P rows takes
// on the current device.
extern "C" int mm_dense_gate_rows(int B, int P, int* rows_out) {
#ifdef MM_GATE_ROWS
  static_assert(MM_GATE_ROWS >= 16 && MM_GATE_ROWS <= 256 && MM_GATE_ROWS % 16 == 0,
                "MM_GATE_ROWS: a multiple of 16 in [16, 256]");
  *rows_out = MM_GATE_ROWS;
#else
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const int per_base = 2 * sms / B > 0 ? 2 * sms / B : 1;
  int rows = ((P + per_base - 1) / per_base + 15) / 16 * 16;
  *rows_out = rows < 64 ? 64 : (rows > 128 ? 128 : rows);
#endif
  return (int)cudaSuccess;
}

extern "C" int mm_dense_gate(const float* p_feat, const float* q_feat,
                             const int* p_cell, const int* q_cell,
                             const int* rp, const int* rq, const float* alpha,
                             const int* p_count, const int* q_count,
                             const int* live, int* row_best, int* counts,
                             int B, int P, int Q, int q_tile, int n_sub,
                             float tol, float thr, int rand_mask, int marker,
                             int skip_dist, int check_cos, void* stream) {
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  if (q_tile <= 0 || Q % q_tile || n_sub < 1 || n_sub > kSub || q_tile % n_sub ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int rows = 0;
  const int e = mm_dense_gate_rows(B, P, &rows);
  if (e != (int)cudaSuccess) return e;
  dim3 grid((P + rows - 1) / rows, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (skip_dist && check_cos) {
    err = launch<true, true>(grid, rows, st, p_feat, q_feat, p_cell, q_cell, rp,
                             rq, alpha, p_count, q_count, live, row_best, counts,
                             P, Q, q_tile, n_sub, tol, thr, rand_mask, marker);
  } else if (skip_dist) {
    err = launch<true, false>(grid, rows, st, p_feat, q_feat, p_cell, q_cell, rp,
                              rq, alpha, p_count, q_count, live, row_best, counts,
                              P, Q, q_tile, n_sub, tol, thr, rand_mask, marker);
  } else if (check_cos) {
    err = launch<false, true>(grid, rows, st, p_feat, q_feat, p_cell, q_cell, rp,
                              rq, alpha, p_count, q_count, live, row_best, counts,
                              P, Q, q_tile, n_sub, tol, thr, rand_mask, marker);
  } else {
    err = launch<false, false>(grid, rows, st, p_feat, q_feat, p_cell, q_cell, rp,
                               rq, alpha, p_count, q_count, live, row_best, counts,
                               P, Q, q_tile, n_sub, tol, thr, rand_mask, marker);
  }
  return (int)err;
}
