// Fused per-block sweep of a dense-relabeled 3D stack (Hopper, sm_90a).
//
// Replaces both TPU kernels of tissue_analysis_tpu/ops/pallas_block.py,
// which share one per-block contract:
//   - _kernel_factory_v2 (kernel-v2, line 830): block 8x16x128, n < 2^16;
//   - _kernel_factory (kernel-v1, line 678): any block shape and label
//     count. It carries every 2D image (lifted to [1, Y, X], block
//     1x128x128) and every label space with n >= 2^16 (int32 labels).
// The TPU's workarounds are not carried over: bf16 one-hot MXU dots, 8-bit
// value splits, hi/lo split columns, the hashed min/max dictionary chain,
// extras plane packing, and v1's three globally shifted neighbour copies.
// A second kernel, block_label_count_kernel, runs the sweep's dictionary
// step alone and writes each block's dictionary size and the largest, so
// that a caller picks the sweep's L (or no block sweep at all) before the
// sweep.
//
// Contract, per voxel block of shape (bz, by, bx) in z-major block order
// (every access is masked by coordinate, so no padded copy of the stack
// exists and no fill value is trusted: any value could be a live label):
//   1. dictionary: the distinct labels < n of the block's voxels and of the
//      +1 z/y/x neighbours just past its far faces, collected in a shared
//      open-addressing hash, then ranked so slots hold ascending ids (IMAX
//      in empty slots). More than L distinct labels sets ovf[b]; the rest
//      of that block's outputs is then undefined and the caller reruns with
//      a larger L.
//   2. per slot: count, sum z/y/x and the six sum c_i*c_j in LOCAL
//      coordinates (int32; K * (extent-1)^2 < 2^31 is checked by the
//      wrapper, and every partial sum below is a sum over a subset of one
//      block's voxels), bbox min/max; globalized once per slot in int64.
//   3. faces[slot(a), d*L + slot(b)] += 1 for every voxel labelled a < n
//      whose +1 neighbour along axis d is labelled b < n, b != a, added
//      into the caller's zeroed [B, L, 3L] buffer.
//
// What bounds it. The bytes, each label read once and each output written
// once, at 3.35 TB/s (H100 SXM): 0.119 ms at 512^3 uint16 L = 32, 0.015 ms
// for a 4096^2 image at L = 32, 0.675 ms for the 262,144-label grid at
// L = 128 and 2.00 ms for the 524,288-label grid at L = 512 (their dense
// face output, 1.7 and 6.6 GB). The first design took 7.6, 1.0, 5.1 and
// 3.0 ms there (64x, 68x, 7.6x and 1.5x its bound); this one 1.9, 0.24,
// 1.9 and 2.8 ms (PERF.md). What held the first back, and what this design
// does about each:
//   - 16 shared atomics per voxel on the voxel's slot, while a warp's 32
//     lanes mostly share one label (32-way serialisation). Now a lane walks
//     its voxels (up to 4 consecutive x per row, rows of one y in z) as runs
//     of one slot and sums a run in registers: a voxel adds to the run's
//     row part (count, sum x, sum x^2, x range), folded into the ten
//     moments once per row. A run is flushed with plain atomics where its
//     slot changes (few lanes at a time, on distinct slots); at the end of
//     a block the open runs are merged over a shuffle tree (equal slots of
//     neighbouring lanes) before the remaining lanes flush. Face keys
//     (s, d, t) are counted the same way: lanes holding one key side by
//     side add their number in one atomic. Dictionary inserts run only at
//     run starts.
//   - Two global reads of every voxel with 2-byte loads, plus three
//     neighbour reads, and a division by the block shape per voxel. Now a
//     lane reads its four labels in one 8- or 16-byte load where aligned,
//     the row it loads as the +z neighbour is its next row, the +x
//     neighbour of its last voxel comes from the next lane by a shuffle,
//     and loops run over rows and x with no per-voxel division.
//   - One CTA per voxel block, serial phases with nothing in flight. Now
//     persistent CTAs, as many as fit (occupancy) times the SMs, walk the
//     blocks with a stride of the grid; 256 threads a CTA, four CTAs an
//     SM up to L = 512, so one CTA's barriers overlap the others' work.
//   - cudaFuncSetAttribute on every launch. Now once per instantiation and
//     device; occupancies and SM counts are cached.
// Measured and not kept (PERF.md): staging each block's labels and its
// halo faces in shared memory with 16-byte cp.async, one or two buffers,
// was slower than reading through L1 at every shape; warp aggregation with
// __match_any_sync and __reduce_*_sync on every flush cost more than the
// atomics it saved; the [L, 3L] face matrix in shared memory (zeroed and
// copied out per block) was within 2 % at L = 32 and took half again as
// long at L = 128 as atomics into the zeroed output, so faces always go
// there.
// Tensor cores are weighed and not used. The TPU counted faces with one-hot
// bf16 dots; on Hopper that product is 3*K*L^2 multiply-adds per block,
// ~0.8e12 operations at 512^3 and L = 32, >= 0.4 ms even at the int8 peak
// of 1,979 TOP/s: above the 0.119 ms memory bound, and it grows with L^2.
// The rank step stays O(H^2 / threads), H = 2L rounded up to a power of
// two (4,096 compares a thread at L = 512).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cuda_runtime.h>

namespace {

constexpr int kIMax = 0x7fffffff;
constexpr int kEmpty = -1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kMaxDevices = 64;

struct Params {
  int Z, Y, X;
  int bz, by, bx;
  int gy, gx;
  long long B;
  int L, n, hbits;
  int chunk;  // x voxels per lane and pass: min(4, ceil(bx / 32))
};

// One voxel block's place in the stack: origin, the extent of its voxels
// inside the stack (e*), and that extent plus the +1 neighbour plane past
// the far face where the stack has one (t*).
struct Geo {
  int oz, oy, ox;
  int ez, ey, ex;
  int tz, ty, tx;
};

__device__ __forceinline__ Geo block_geo(const Params& p, long long b) {
  Geo g;
  const long long r = b / p.gx;
  g.ox = static_cast<int>(b - r * p.gx) * p.bx;
  g.oy = static_cast<int>(r % p.gy) * p.by;
  g.oz = static_cast<int>(r / p.gy) * p.bz;
  g.ez = min(p.bz, p.Z - g.oz);
  g.ey = min(p.by, p.Y - g.oy);
  g.ex = min(p.bx, p.X - g.ox);
  g.tz = g.ez + (g.oz + p.bz < p.Z ? 1 : 0);
  g.ty = g.ey + (g.oy + p.by < p.Y ? 1 : 0);
  g.tx = g.ex + (g.ox + p.bx < p.X ? 1 : 0);
  return g;
}

__device__ __forceinline__ unsigned hash_pos(int key, int hbits) {
  return (static_cast<unsigned>(key) * 2654435761u) >> (32 - hbits);
}

// Insert key into the shared hash (linear probing). Counts distinct keys;
// flags a full table (only possible when the block already overflows L).
__device__ __forceinline__ void dict_insert(int* keys, int key, int hbits,
                                            int* ndistinct, int* full) {
  const unsigned mask = (1u << hbits) - 1u;
  unsigned h = hash_pos(key, hbits);
  for (unsigned probe = 0; probe <= mask; ++probe) {
    const int prev = atomicCAS(&keys[h], kEmpty, key);
    if (prev == kEmpty) {
      atomicAdd(ndistinct, 1);
      return;
    }
    if (prev == key) return;
    h = (h + 1u) & mask;
  }
  *full = 1;
}

// Slot of key after ranking, or -1 (absent, or ranked past L on overflow).
__device__ __forceinline__ int dict_slot(const int* keys, const int* slots,
                                         int key, int hbits) {
  const unsigned mask = (1u << hbits) - 1u;
  unsigned h = hash_pos(key, hbits);
  for (unsigned probe = 0; probe <= mask; ++probe) {
    const int k = keys[h];
    if (k == key) return slots[h];
    if (k == kEmpty) return -1;
    h = (h + 1u) & mask;
  }
  return -1;
}

// a label takes part iff 0 <= v < n (unsigned compare)
__device__ __forceinline__ bool live(int v, int n) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(n);
}

// v[c] = the label at x0 + c of the row at q, for c < chunk and
// x0 + c < lim, else kEmpty. Four aligned labels come in one 8- or 16-byte
// load through L1.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* q, int x0, int chunk,
                                           int lim, int (&v)[4]) {
  q += x0;
  if (chunk == 4 && x0 + 4 <= lim &&
      (reinterpret_cast<uintptr_t>(q) & (4 * sizeof(T) - 1)) == 0) {
    if constexpr (sizeof(T) == 2) {
      const ushort4 u = __ldg(reinterpret_cast<const ushort4*>(q));
      v[0] = u.x;
      v[1] = u.y;
      v[2] = u.z;
      v[3] = u.w;
    } else {
      const int4 u = __ldg(reinterpret_cast<const int4*>(q));
      v[0] = u.x;
      v[1] = u.y;
      v[2] = u.z;
      v[3] = u.w;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = (c < chunk && x0 + c < lim) ? static_cast<int>(__ldg(q + c)) : kEmpty;
  }
}

// A lane's run: the moments and bbox of its voxels of one slot. A voxel
// adds to the run's part in the current row (count, sum x, sum x^2, x
// range); fold() adds that part to the moments at the row's (z, y).
struct Run {
  int s;  // slot, or -1 (no run)
  int m[10];
  int lo[3], hi[3];
  int rk, rsx, rsxx, rxlo, rxhi;

  __device__ __forceinline__ void reset() {
    s = -1;
#pragma unroll
    for (int q = 0; q < 10; ++q) m[q] = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = kIMax;
      hi[d] = -1;
    }
    rk = rsx = rsxx = 0;
    rxlo = kIMax;
    rxhi = -1;
  }
  __device__ __forceinline__ void add(int x) {
    ++rk;
    rsx += x;
    rsxx += x * x;
    rxlo = min(rxlo, x);
    rxhi = max(rxhi, x);
  }
  __device__ __forceinline__ void fold(int z, int y) {
    if (rk == 0) return;
    m[0] += rk;
    m[1] += rk * z;
    m[2] += rk * y;
    m[3] += rsx;
    m[4] += rk * z * z;
    m[5] += rk * z * y;
    m[6] += z * rsx;
    m[7] += rk * y * y;
    m[8] += y * rsx;
    m[9] += rsxx;
    lo[0] = min(lo[0], z);
    hi[0] = max(hi[0], z);
    lo[1] = min(lo[1], y);
    hi[1] = max(hi[1], y);
    lo[2] = min(lo[2], rxlo);
    hi[2] = max(hi[2], rxhi);
    rk = rsx = rsxx = 0;
    rxlo = kIMax;
    rxhi = -1;
  }
};

// Add a folded run to the block's shared moments and bbox, and reset it.
__device__ __forceinline__ void flush_run(Run& run, int* acc, int* bmin,
                                          int* bmax) {
  int* m = acc + 10 * run.s;
#pragma unroll
  for (int q = 0; q < 10; ++q) {
    if (run.m[q] != 0) atomicAdd(&m[q], run.m[q]);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    atomicMin(&bmin[3 * run.s + d], run.lo[d]);
    atomicMax(&bmax[3 * run.s + d], run.hi[d]);
  }
  run.reset();
}

// The folded runs still open at the end of a block (every lane has one):
// merged over a shuffle tree first (at level o, lane l takes lane l+o's run
// when l is a multiple of 2o and both hold the same slot; the lanes of a
// slot are mostly neighbours, since a warp's lanes hold consecutive x),
// then the lanes that were not taken flush what they hold.
__device__ __forceinline__ void warp_flush_all(Run& run, int* acc, int* bmin,
                                               int* bmax, int lane) {
  bool taken = false;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int other = __shfl_down_sync(kFull, run.s, o);
    const int left = __shfl_up_sync(kFull, run.s, o);
    const bool recv = (lane & (2 * o - 1)) == 0 && run.s >= 0 && other == run.s;
    if ((lane & (2 * o - 1)) == o && run.s >= 0 && left == run.s) taken = true;
#pragma unroll
    for (int q = 0; q < 10; ++q) {
      const int v = __shfl_down_sync(kFull, run.m[q], o);
      if (recv) run.m[q] += v;
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int lo = __shfl_down_sync(kFull, run.lo[d], o);
      const int hi = __shfl_down_sync(kFull, run.hi[d], o);
      if (recv) {
        run.lo[d] = min(run.lo[d], lo);
        run.hi[d] = max(run.hi[d], hi);
      }
    }
  }
  if (!taken && run.s >= 0) flush_run(run, acc, bmin, bmax);
  run.reset();
}

// Add the faces whose key >= 0 (called by all 32 lanes). Lanes holding one
// key side by side count as one atomic of their number; the first lane of
// each such stretch adds it.
__device__ __forceinline__ void warp_faces(int key, int* fc, int lane) {
  if (!__any_sync(kFull, key >= 0)) return;
  const int left = __shfl_up_sync(kFull, key, 1);
  const bool start = lane == 0 || key != left;
  const unsigned starts = __ballot_sync(kFull, start);
  if (start && key >= 0) {
    const unsigned above = starts & ~((2u << lane) - 1u);
    const int next = above ? __ffs(above) - 1 : 32;
    atomicAdd(&fc[key], next - lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
block_sweep_kernel(const T* __restrict__ dense, Params p,
                   int* __restrict__ ids_out, long long* __restrict__ mom_out,
                   int* __restrict__ gmin_out, int* __restrict__ gmax_out,
                   int* __restrict__ faces_out, int* __restrict__ ovf_out) {
  extern __shared__ int smem[];
  const int L = p.L;
  const int n = p.n;
  const int H = 1 << p.hbits;
  int* hkeys = smem;         // [H]
  int* hslot = hkeys + H;    // [H]
  int* acc = hslot + H;      // [L, 10] local moments
  int* bmin = acc + 10 * L;  // [L, 3]
  int* bmax = bmin + 3 * L;  // [L, 3]
  int* misc = bmax + 3 * L;  // ndistinct, full

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = p.chunk;
  const long long sz = static_cast<long long>(p.Y) * p.X;

  for (long long b = blockIdx.x; b < p.B; b += gridDim.x) {
    const Geo g = block_geo(p, b);
    // the block's (0, 0, 0) voxel, and the start of its row (lz, ly)
    const T* base = dense + g.oz * sz + static_cast<long long>(g.oy) * p.X + g.ox;
    auto row = [&](int lz, int ly) {
      return base + lz * sz + static_cast<long long>(ly) * p.X;
    };
    // x passes of 32 lanes x chunk voxels over the block's extent
    const int npass = (g.ex + 32 * chunk - 1) / (32 * chunk);
    int* fc = faces_out + b * 3 * L * L;

    // ---- reset the block's shared state
    for (int i = tid; i < H; i += kThreads) {
      hkeys[i] = kEmpty;
      hslot[i] = -1;
    }
    for (int i = tid; i < 10 * L; i += kThreads) acc[i] = 0;
    for (int i = tid; i < 3 * L; i += kThreads) {
      bmin[i] = kIMax;
      bmax[i] = -1;
    }
    if (tid == 0) {
      misc[0] = 0;
      misc[1] = 0;
    }
    __syncthreads();

    // ---- 1. dictionary: the rows of the block and of its +z plane and +y
    // row (x < ex), and the +x column of the block's own rows (a neighbour
    // label absent from the block itself still needs a slot, or its face
    // pair would vanish). A label equal to the voxel on its left is
    // inserted by the lane holding that voxel, or was already.
    {
      int last = kEmpty;
      for (int ly = warp; ly < g.ty; ly += kWarps) {
        for (int pass = 0; pass < npass; ++pass) {
          const int x0 = (pass * 32 + lane) * chunk;
          for (int lz = 0; lz < g.tz; ++lz) {
            if (lz == p.bz && ly == p.by) continue;  // never a neighbour
            int v[4];
            load_chunk(row(lz, ly), x0, chunk, g.ex, v);
            const int tail =
                chunk == 4 ? v[3] : chunk == 3 ? v[2] : chunk == 2 ? v[1] : v[0];
            const int left = __shfl_up_sync(kFull, tail, 1);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int prev =
                  c == 0 ? (lane == 0 ? kEmpty : left) : v[c > 0 ? c - 1 : 0];
              if (live(v[c], n) && v[c] != prev && v[c] != last)
                dict_insert(hkeys, v[c], p.hbits, &misc[0], &misc[1]);
              if (live(v[c], n)) last = v[c];
            }
          }
        }
        if (lane == 0 && g.tx > g.ex && ly < g.ey) {
          for (int lz = 0; lz < g.ez; ++lz) {
            const int v = __ldg(row(lz, ly) + g.ex);
            if (live(v, n)) dict_insert(hkeys, v, p.hbits, &misc[0], &misc[1]);
          }
        }
      }
    }
    __syncthreads();

    // ---- rank: slot = number of smaller keys, so slots ascend by id
    const int nd = misc[0];
    if (tid == 0) ovf_out[b] = (nd > L || misc[1]) ? 1 : 0;
    for (int h = tid; h < H; h += kThreads) {
      const int k = hkeys[h];
      if (k == kEmpty) continue;
      int r = 0;
      for (int j = 0; j < H; ++j) {
        const int o = hkeys[j];
        r += (o != kEmpty && o < k) ? 1 : 0;
      }
      if (r < L) {
        hslot[h] = r;
        ids_out[b * L + r] = k;
      }
    }
    for (int s = nd + tid; s < L; s += kThreads) ids_out[b * L + s] = kIMax;
    __syncthreads();

    // ---- 2+3. moments and bbox by runs, faces by key. A warp walks the
    // rows of one y in z, so the +z row it loads is its next row.
    {
      Run run;
      run.reset();
      int last_a = kEmpty, last_sa = -1, last_c = kEmpty, last_t = -1;
      for (int ly = warp; ly < g.ey; ly += kWarps) {
        const bool yn = ly + 1 < g.ty;
        for (int pass = 0; pass < npass; ++pass) {
          const int x0 = (pass * 32 + lane) * chunk;
          int a4[4], z4[4], y4[4];
          load_chunk(row(0, ly), x0, chunk, g.tx, a4);
          for (int lz = 0; lz < g.ez; ++lz) {
            if (lz + 1 < g.tz) {
              load_chunk(row(lz + 1, ly), x0, chunk, g.tx, z4);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) z4[c] = kEmpty;
            }
            if (yn) {
              load_chunk(row(lz, ly + 1), x0, chunk, g.tx, y4);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) y4[c] = kEmpty;
            }
            // +x neighbour of the lane's last voxel: the next lane's first,
            // or for lane 31 the next pass's first or the x halo
            int xh = __shfl_down_sync(kFull, a4[0], 1);
            if (lane == 31) {
              const int xn = x0 + chunk;
              xh = xn < g.tx ? static_cast<int>(__ldg(row(lz, ly) + xn)) : kEmpty;
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (c >= chunk) break;
              const int x = x0 + c;
              const int a = x < g.ex ? a4[c] : kEmpty;
              int s = -1;
              if (live(a, n)) {
                if (a != last_a) {
                  last_a = a;
                  last_sa = dict_slot(hkeys, hslot, a, p.hbits);
                }
                s = last_sa;
              }
              int kz = -1, ky = -1, kx = -1;
              if (s >= 0) {
                if (s != run.s) {
                  run.fold(lz, ly);
                  if (run.s >= 0) flush_run(run, acc, bmin, bmax);
                  run.s = s;
                }
                run.add(x);
                auto face = [&](int v, int d) -> int {
                  if (v == a || !live(v, n)) return -1;
                  if (v != last_c) {
                    last_c = v;
                    last_t = dict_slot(hkeys, hslot, v, p.hbits);
                  }
                  return last_t < 0 ? -1 : (s * 3 + d) * L + last_t;
                };
                kz = face(z4[c], 0);
                ky = face(y4[c], 1);
                kx = face(c < 3 && c + 1 < chunk ? a4[c < 3 ? c + 1 : 3] : xh, 2);
              }
              if (__any_sync(kFull, (kz & ky & kx) != -1)) {
                warp_faces(kz, fc, lane);
                warp_faces(ky, fc, lane);
                warp_faces(kx, fc, lane);
              }
            }
            run.fold(lz, ly);
#pragma unroll
            for (int c = 0; c < 4; ++c) a4[c] = z4[c];
          }
        }
      }
      warp_flush_all(run, acc, bmin, bmax, lane);
    }
    __syncthreads();

    // ---- globalize once per slot, in int64:
    // sum c_g = s_c + C*o_c;  S_ij,g = S_ij + o_i*s_j + o_j*s_i + C*o_i*o_j
    const long long o[3] = {g.oz, g.oy, g.ox};
    for (int s = tid; s < L; s += kThreads) {
      const int* m = acc + 10 * s;
      const long long C = m[0];
      const long long s1[3] = {m[1], m[2], m[3]};
      long long* out = mom_out + (b * L + s) * 10;
      out[0] = C;
      for (int d = 0; d < 3; ++d) out[1 + d] = s1[d] + C * o[d];
      // tri_pairs order: zz, zy, zx, yy, yx, xx
      const int pi[6] = {0, 0, 0, 1, 1, 2};
      const int pj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const int i = pi[q], j = pj[q];
        out[4 + q] = static_cast<long long>(m[4 + q]) + o[i] * s1[j] +
                     o[j] * s1[i] + C * o[i] * o[j];
      }
      for (int d = 0; d < 3; ++d) {
        const int lo = bmin[3 * s + d], hi = bmax[3 * s + d];
        gmin_out[(b * L + s) * 3 + d] =
            lo == kIMax ? kIMax : lo + static_cast<int>(o[d]);
        gmax_out[(b * L + s) * 3 + d] = hi < 0 ? -1 : hi + static_cast<int>(o[d]);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ the count
// The dictionary pass of block_sweep_kernel alone (no TPU counterpart: it
// stands where the reference's engine catches a failed sweep and falls back
// to another engine). count[b] is the number of distinct labels < n among
// block b's voxels and the +1 z/y/x neighbours just past its far faces
// (step 1 of the contract above), saturated at cap + 1, so count[b] > L
// exactly where a sweep at L sets ovf[b], for every L <= cap. The kernel
// also writes the largest count, so the caller reads one int and launches
// no reduction of its own. A block stops inserting once its count passes
// cap (a block of 16,384 distinct labels would otherwise probe a full
// table on every insert), so the hash of >= 1.25 (cap + 1) slots fills
// only past cap.
//
// What bounds it: the bytes of the stack and of its far-face planes, read
// once (x ~1.2 at the default block), and 4 B a block written, with about
// four integer operations a voxel. On this card the copies alone reach
// that bound (the TMA tiles with the count skipped: PERF.md); what is left
// is the count's own instructions a label and the shared-memory atomics
// of blocks with many labels, so its time follows the warps an SM can hold.
// The first design held one load in flight a warp, cleared all 8,192 hash
// slots a block and kept 17 rows over 8 warps (27 dependent loads for one
// warp, 18 for the others). This one:
//   - bulk path (the stack's first byte and row pitch multiples of 16
//     bytes): a persistent CTA copies a block's tile, its voxels and its
//     far-face planes (box bz+1, by+1, bx+1 rounded up to 16 bytes), into
//     shared memory with one TMA load (cp.async.bulk.tensor.3d) that a
//     producer warp starts and an mbarrier completes; the same warp
//     computes the next block's place, so no counting warp waits on either.
//     A tile's voxels outside the stack are zero-filled by the copy, and 0
//     is a live label: every read stays masked by the block's Geo extents.
//     One tile a CTA, so that a CTA is ~62 KB (uint16) or ~102 KB (int32)
//     and three or two CTAs share an SM; their copies and counts overlap.
//   - the tile is counted as the sweep's lanes walk device memory: a lane
//     walks 16 bytes of x (8 uint16 or 4 int32 labels) up through z, and
//     inserts a label that differs from the voxel on its left and from
//     the last live label it saw; a row equal to the row below adds
//     nothing. The 17 rows of y of a block are two to a warp over 9 warps
//     (uint16), or one to a warp over 18 (int32).
//   - direct path (other stacks, which TMA cannot address): the sweep's
//     step 1, one 8- or 16-byte load a lane and row, 9 warps, and a vote
//     a row on whether the block has passed cap.
//   - the per-block reset follows the labels: an insert lists the slot it
//     filled and the block clears those (all slots only past nlist labels).
//   - the largest count: thread 0 keeps its CTA's, adds it to a two-int
//     workspace by atomicMax, and the last CTA to take a ticket writes it
//     out and resets the workspace for the next launch.
// Measured and not kept (scripts/torch_count_variants.py, H100 80GB HBM3
// at 700 W, voronoi-512 uint16, where this design takes 0.217 ms, the
// first 0.373, and the copies alone 0.101; PERF.md): a ring of two tiles a
// CTA 0.243 ms and of up to four beside a hash of 2^13 slots 0.422 (one
// CTA an SM: the copies were in flight but the count ran on 9-18 warps an
// SM); one tile beside that hash 0.278; direct loads where TMA could run
// 0.291; int32 tiles counted by 288 threads 0.335 ms at int32 (576: 0.276).
// Slower than the first design, in builds of earlier sources (no times
// kept): the tile's rows split evenly over threads, 16 bytes a thread
// tested against the row below (more instructions a label, and a warp's
// lanes diverging into the per-label test); the direct path loading 9 rows
// a lane before inserting (more registers, fewer CTAs an SM); a check of
// each row against the row one y back; testing whether a key is present
// before reading the block's count.

struct CountPlan {
  int cap;          // counts saturate at cap + 1
  int hbits;        // hash of 2^hbits >= 1.25 (cap + 1) slots
  int nlist;        // filled slots listed a block (all cleared past this)
  int stages;       // label tiles a CTA on the bulk path; 0 = direct loads
  int box_z, box_y, box_x;  // a tile: the block and its far-face planes
  int stage_bytes;  // bytes from one tile to the next, a multiple of 128
};

// Counting threads a CTA: 9 warps (the 17 rows of y of a default block,
// two to a warp for uint16 tiles and on the direct path), 18 for int32
// tiles (a row of 128 int32 is a warp's 32 lanes of 16 bytes).
template <typename T, bool kBulk>
__host__ __device__ constexpr int count_threads() {
  return kBulk && sizeof(T) == 4 ? 576 : 288;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Copy the tile of the block at (ox, oy, oz) into dst; bytes land on bar.
__device__ __forceinline__ void copy_tile(const CUtensorMap* tmap, unsigned long long* bar,
                                           void* dst, int bytes, int ox, int oy, int oz) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(ox), "r"(oy), "r"(oz), "r"(b)
      : "memory");
}

// dict_insert for the count: cnt = {distinct, full}. A slot is read before
// any atomic (most keys are in the table already); the first nlist slots
// filled are listed, so that the block clears only those.
__device__ __forceinline__ void count_insert(int* keys, int* listed, int nlist, int key,
                                             int hbits, int* cnt) {
  const volatile int* vkeys = keys;
  const unsigned mask = (1u << hbits) - 1u;
  unsigned h = hash_pos(key, hbits);
  for (unsigned probe = 0; probe <= mask; ++probe) {
    const int k = vkeys[h];
    if (k == key) return;
    if (k == kEmpty) {
      const int prev = atomicCAS(&keys[h], kEmpty, key);
      if (prev == kEmpty) {
        const int i = atomicAdd(&cnt[0], 1);
        if (i < nlist) listed[i] = static_cast<int>(h);
        return;
      }
      if (prev == key) return;
    }
    h = (h + 1u) & mask;
  }
  cnt[1] = 1;
}

// The insert of label a by one thread: not again if it is the label the
// thread inserted last in this block, nor once the block's count is past
// cap.
struct Inserter {
  int* hkeys;
  int* listed;
  int* bc;
  int nlist, hbits, cap;
  int last;

  __device__ __forceinline__ void operator()(int a) {
    if (a == last || *reinterpret_cast<const volatile int*>(bc) > cap) return;
    count_insert(hkeys, listed, nlist, a, hbits, bc);
    last = a;
  }
};

// label k of 16 bytes of labels held in registers
template <typename T>
__device__ __forceinline__ int label_of(const uint4& w, int k) {
  const int i = sizeof(T) == 2 ? k >> 1 : k;
  const unsigned word = i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
  return sizeof(T) == 2 ? static_cast<int>((word >> (16 * (k & 1))) & 0xffffu)
                        : static_cast<int>(word);
}

// Bulk path: insert one block's labels from its tile in shared memory. A
// unit is the column of rows (lz = 0 .. tz-1) at one y of the block (its
// +y row included) and one x pass of seg lanes x 16 bytes (8 uint16 or 4
// int32 labels a lane); seg is 8, 16 or 32 lanes, so that one warp walks
// 32 / seg units at once. A lane walks its column up through z, as the
// sweep's lanes walk device memory, and inserts a label that is live and
// differs from the voxel on its left (the previous lane's last label, by a
// shuffle) and from the last live label it saw (inserted by it, or equal
// to a voxel inserted by the same rule). A row whose 16 bytes equal the
// row below adds nothing. Then the threads take the +x column of the
// block's own rows, a voxel each.
template <typename T>
__device__ __forceinline__ void count_tile(const T* tile, const Geo& g, const Params& p,
                                           const CountPlan& c, Inserter& ins) {
  constexpr int kThr = count_threads<T, true>();
  constexpr int V = 16 / sizeof(T);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int bslots = (p.bx + V - 1) / V;
  const int seg = bslots <= 8 ? 8 : bslots <= 16 ? 16 : 32;
  const int sl = lane & (seg - 1);
  const int per_warp = 32 / seg;
  const int npass = (g.ex + seg * V - 1) / (seg * V);
  const int units = g.ty * npass;
  const int py = c.box_x;
  const int pz = c.box_y * c.box_x;
  for (int u0 = warp * per_warp; u0 < units; u0 += kThr / 32 * per_warp) {
    const int u = u0 + lane / seg;
    const int ly = u / npass;
    const int x0 = ((u - ly * npass) * seg + sl) * V;
    const bool col = u < units && x0 < g.ex;
    const int nv = col ? min(V, g.ex - x0) : 0;
    const T* q = tile + ly * py + x0;
    int last = kEmpty;
    uint4 below = make_uint4(0u, 0u, 0u, 0u);
    for (int lz = 0; lz < g.tz; ++lz, q += pz) {
      // a block past cap stops (the whole warp, by a vote)
      if (__any_sync(kFull, *reinterpret_cast<const volatile int*>(ins.bc) > ins.cap)) break;
      const bool row = col && !(lz == p.bz && ly == p.by);  // that row is never a neighbour
      uint4 w = below;
      if (row) w = *reinterpret_cast<const uint4*>(q);
      int prev = __shfl_up_sync(kFull, label_of<T>(w, V - 1), 1, seg);
      if (sl == 0) prev = row && x0 > 0 ? static_cast<int>(q[-1]) : kEmpty;
      const bool same = lz > 0 &&
          ((w.x ^ below.x) | (w.y ^ below.y) | (w.z ^ below.z) | (w.w ^ below.w)) == 0u;
      if (row && !same) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int v = label_of<T>(w, k);
          if (k < nv && live(v, p.n)) {
            if (v != prev && v != last) ins(v);
            last = v;
          }
          prev = v;
        }
      }
      below = w;
    }
  }
  // the +x column of the block's own rows, a voxel a thread
  const int nhalo = g.tx > g.ex ? g.ez * g.ey : 0;
  for (int i = t; i < nhalo; i += kThr) {
    const int hz = i / g.ey;
    const int hy = i - hz * g.ey;
    const T* h = tile + hz * pz + hy * py + g.ex;
    const int v = static_cast<int>(h[0]);
    if (live(v, p.n) && v != static_cast<int>(h[-1]) && !(hz > 0 && v == static_cast<int>(h[-pz])))
      ins(v);
  }
}

// Direct path: the same inserts from device memory, for a stack that TMA
// cannot address. A warp walks the rows of one y of the block up through z,
// one 8- or 16-byte load a lane and row (block_sweep_kernel's step 1), and
// votes once a row on whether the block has passed cap; the +x column is
// one voxel a lane of the warp, for the rows of its y.
template <typename T>
__device__ __forceinline__ void count_direct(const T* dense, const Geo& g, const Params& p,
                                             Inserter& ins) {
  constexpr int kWarpsD = count_threads<T, false>() / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = p.chunk;
  const long long sz = static_cast<long long>(p.Y) * p.X;
  const T* base = dense + g.oz * sz + static_cast<long long>(g.oy) * p.X + g.ox;
  auto row = [&](int lz, int ly) {
    return base + lz * sz + static_cast<long long>(ly) * p.X;
  };
  const volatile int* nd = ins.bc;
  const int npass = (g.ex + 32 * chunk - 1) / (32 * chunk);
  int last = kEmpty;
  for (int ly = warp; ly < g.ty; ly += kWarpsD) {
    for (int pass = 0; pass < npass; ++pass) {
      const int x0 = (pass * 32 + lane) * chunk;
      for (int lz = 0; lz < g.tz; ++lz) {
        if (lz == p.bz && ly == p.by) continue;  // never a neighbour
        if (__any_sync(kFull, *nd > ins.cap)) return;
        int v[4];
        load_chunk(row(lz, ly), x0, chunk, g.ex, v);
        const int tail = chunk == 4 ? v[3] : chunk == 3 ? v[2] : chunk == 2 ? v[1] : v[0];
        int prev = __shfl_up_sync(kFull, tail, 1);
        if (lane == 0) prev = kEmpty;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (live(v[k], p.n)) {
            if (v[k] != prev && v[k] != last) ins(v[k]);
            last = v[k];
          }
          prev = v[k];
        }
      }
    }
    if (g.tx > g.ex && ly < g.ey) {
      for (int lz = lane; lz < g.ez; lz += 32) {
        const T* q = row(lz, ly) + g.ex;
        const int a = __ldg(q);
        if (live(a, p.n) && a != static_cast<int>(__ldg(q - 1))) ins(a);
      }
    }
  }
}

// count_threads() count; on the bulk path one more warp starts the tile
// copies and computes the next block's place, so that no counting warp
// waits on that work.
template <typename T, bool kBulk>
__global__ void __launch_bounds__(count_threads<T, kBulk>() + (kBulk ? 32 : 0))
block_label_count_kernel(const T* __restrict__ dense, Params p, CountPlan c,
                         const __grid_constant__ CUtensorMap tmap,
                         int* __restrict__ count_out, int* __restrict__ ws) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // ring [stages][stage_bytes] at a 128-byte boundary, mbarriers [stages],
  // hash [H], listed slots [nlist], counts {distinct, full} by block parity
  // and two blocks' Geo (32 ints in all). The boundary is an offset into
  // smem_raw, so that every pointer stays a shared-memory one (LDS, ATOMS):
  // a pointer rounded through an integer compiles to generic accesses.
  unsigned char* ring = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(ring + static_cast<size_t>(c.stages) * c.stage_bytes);
  int* hkeys = reinterpret_cast<int*>(bars + c.stages);
  const int H = 1 << c.hbits;
  int* listed = hkeys + H;
  int* cnt = listed + c.nlist;
  Geo* geo = reinterpret_cast<Geo*>(cnt + 4);  // [2]: the places of blocks by parity

  constexpr int kCount = count_threads<T, kBulk>();
  constexpr int kBlock = kCount + (kBulk ? 32 : 0);
  const int tid = threadIdx.x;
  const int producer = kBulk ? kCount : 0;  // the thread that copies and places
  const int B = static_cast<int>(p.B);
  const int tile_bytes = c.box_z * c.box_y * c.box_x * static_cast<int>(sizeof(T));
  for (int i = tid; i < H; i += kBlock) hkeys[i] = kEmpty;
  if (tid < 4) cnt[tid] = 0;
  if (tid == producer) {
    geo[0] = block_geo(p, blockIdx.x);
    if constexpr (kBulk) {
      for (int s = 0; s < c.stages; ++s) mbar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  if constexpr (kBulk) {
    if (tid == producer) {
      for (int s = 0; s < c.stages; ++s) {
        const int b = blockIdx.x + s * gridDim.x;
        if (b >= B) break;
        const Geo g = block_geo(p, b);
        copy_tile(&tmap, &bars[s], ring + static_cast<size_t>(s) * c.stage_bytes, tile_bytes,
                   g.ox, g.oy, g.oz);
      }
    }
  }

  int best = 0;  // thread 0: the largest count of this CTA's blocks
  int k = 0;     // the CTA's k-th block
  for (int b = blockIdx.x; b < B; b += gridDim.x, ++k) {
    const Geo g = geo[k & 1];
    int* bc = cnt + 2 * (k & 1);
    if (tid == producer) {
      // the next block's place (that buffer was last read before the
      // previous barrier), and the tile of the block S on from the previous
      // one into the stage it freed, while the other threads count
      if (b + static_cast<int>(gridDim.x) < B) geo[(k + 1) & 1] = block_geo(p, b + gridDim.x);
      if constexpr (kBulk) {
        const int nb = b + (c.stages - 1) * gridDim.x;
        if (k > 0 && nb < B) {
          const int s = (k - 1) % c.stages;
          const Geo gn = block_geo(p, nb);
          copy_tile(&tmap, &bars[s], ring + static_cast<size_t>(s) * c.stage_bytes, tile_bytes,
                     gn.ox, gn.oy, gn.oz);
        }
      }
    }
    Inserter ins{hkeys, listed, bc, c.nlist, c.hbits, c.cap, kEmpty};
    if constexpr (kBulk) {
      const int s = k % c.stages;
      if (tid < kCount) {
        mbar_wait(&bars[s], (k / c.stages) & 1);
        count_tile<T>(reinterpret_cast<const T*>(ring + static_cast<size_t>(s) * c.stage_bytes),
                      g, p, c, ins);
      }
    } else {
      count_direct<T>(dense, g, p, ins);
    }
    __syncthreads();
    // every insert of block b is done, and so is every read of its tile
    const int nd = bc[0];
    if (tid == 0) {
      const int got = (nd > c.cap || bc[1]) ? c.cap + 1 : nd;
      count_out[b] = got;
      best = max(best, got);
      int* other = cnt + 2 * ((k + 1) & 1);  // last read before the previous barrier
      other[0] = 0;
      other[1] = 0;
    }
    if (nd <= c.nlist) {
      for (int i = tid; i < nd; i += kBlock) hkeys[listed[i]] = kEmpty;
    } else {
      for (int i = tid; i < H; i += kBlock) hkeys[i] = kEmpty;
    }
    __syncthreads();
  }

  // the largest count: the last CTA to take a ticket writes it and resets
  // the workspace {ticket, max} for the next launch
  if (tid == 0) {
    atomicMax(&ws[1], best);
    __threadfence();
    const unsigned t = atomicAdd(reinterpret_cast<unsigned*>(&ws[0]), 1u);
    if (t == gridDim.x - 1) {
      __threadfence();
      count_out[B] = atomicExch(&ws[1], 0);
      atomicExch(&ws[0], 0);
    }
  }
}

int hash_bits(int L) {
  int bits = 6;  // at least 64 entries, and at least 2L (load <= 1/2)
  while ((1 << bits) < 2 * L) ++bits;
  return bits;
}

// bytes of a block's shared state: hash, moments, bbox, two counters
long long smem_bytes(int L) {
  const long long H = 1LL << hash_bits(L);
  return (2 * H + 16LL * L + 2) * static_cast<long long>(sizeof(int));
}

// ---------------------------------------------------------------- host side
// Kernels by index: 0/1 the sweep (uint16/int32); 2/3 the count by direct
// loads, 4/5 the count by tiles (uint16/int32).
constexpr int kKernels = 6;

const void* kernel_of(int fn) {
  switch (fn) {
    case 0: return reinterpret_cast<const void*>(&block_sweep_kernel<unsigned short>);
    case 1: return reinterpret_cast<const void*>(&block_sweep_kernel<int>);
    case 2: return reinterpret_cast<const void*>(&block_label_count_kernel<unsigned short, false>);
    case 3: return reinterpret_cast<const void*>(&block_label_count_kernel<int, false>);
    case 4: return reinterpret_cast<const void*>(&block_label_count_kernel<unsigned short, true>);
    default: return reinterpret_cast<const void*>(&block_label_count_kernel<int, true>);
  }
}

int threads_of(int fn) {
  switch (fn) {
    case 0: case 1: return kThreads;
    case 2: return count_threads<unsigned short, false>();
    case 3: return count_threads<int, false>();
    case 4: return count_threads<unsigned short, true>() + 32;
    default: return count_threads<int, true>() + 32;
  }
}

// per kernel, a bit per device whose attribute is set
std::atomic<unsigned long long> g_attr_set[kKernels];
std::mutex g_cache_mu;
int g_sms[kMaxDevices];
struct OccEntry {
  int dev, fn, smem, ctas;
};
OccEntry g_occ[64];
int g_nocc = 0;

// The SMs of device dev and the CTAs an SM holds of kernel fn at smem
// bytes. Sets the kernel's dynamic shared-memory ceiling once per device;
// both answers are cached.
cudaError_t occupancy(int dev, int fn, int smem, int* ctas, int* sms) {
  const unsigned long long bit = 1ULL << dev;
  if (!(g_attr_set[fn].load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of(fn), cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    g_attr_set[fn].fetch_or(bit, std::memory_order_release);
  }
  std::lock_guard<std::mutex> lock(g_cache_mu);
  if (g_sms[dev] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = g_sms[dev];
  const int cached = g_nocc < 64 ? g_nocc : 64;
  for (int i = 0; i < cached; ++i) {
    const OccEntry& e = g_occ[i];
    if (e.dev == dev && e.fn == fn && e.smem == smem) {
      *ctas = e.ctas;
      return cudaSuccess;
    }
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel_of(fn), threads_of(fn), static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  if (*ctas < 1) return cudaErrorInvalidConfiguration;
  g_occ[g_nocc % 64] = OccEntry{dev, fn, smem, *ctas};
  ++g_nocc;
  return cudaSuccess;
}

Params make_params(int Z, int Y, int X, int bz, int by, int bx, int L, int n,
                   int hbits) {
  Params p;
  p.Z = Z;
  p.Y = Y;
  p.X = X;
  p.bz = bz;
  p.by = by;
  p.bx = bx;
  const int gz = (Z + bz - 1) / bz;
  p.gy = (Y + by - 1) / by;
  p.gx = (X + bx - 1) / bx;
  p.B = static_cast<long long>(gz) * p.gy * p.gx;
  p.L = L;
  p.n = n;
  p.hbits = hbits;
  p.chunk = (bx + 31) / 32 < 4 ? (bx + 31) / 32 : 4;
  return p;
}

// Persistent CTAs of kernel fn: as many as fit an SM at smem bytes times
// the SMs, no more than the blocks. Returns cudaGetLastError().
int launch(int fn, long long B, int smem, void** args, void* stream) {
  int dev = 0, ctas = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  err = occupancy(dev, fn, smem, &ctas, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = static_cast<long long>(ctas) * sms;
  const unsigned grid = static_cast<unsigned>(B < want ? B : want);
  err = cudaLaunchKernel(kernel_of(fn), dim3(grid), dim3(threads_of(fn)), args,
                         static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// libcuda's cuTensorMapEncodeTiled, found once through the runtime's
// entry-point query (so the library needs no -lcuda); null where libcuda
// has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of one block's state at dictionary size L.
long long ta_block_sweep_smem_bytes(int L) { return smem_bytes(L); }

// dense: [Z, Y, X] uint16 (is_int32 == 0) or int32, contiguous, on the device.
// Outputs (allocated by the caller): ids int32 [B, L], mom int64 [B, L, 10],
// gmin/gmax int32 [B, L, 3] and ovf int32 [B] are written here; the kernel
// adds into faces int32 [B, L, 3L], which the caller zeroes on the same
// stream first. Launches on `stream`, does not synchronise; returns
// cudaGetLastError().
int ta_block_sweep(const void* dense, int is_int32, int Z, int Y, int X,
                   int bz, int by, int bx, int L, int n, void* ids, void* mom,
                   void* gmin, void* gmax, void* faces, void* ovf, void* stream) {
  Params p = make_params(Z, Y, X, bz, by, bx, L, n, hash_bits(L));
  if (p.B == 0) return 0;
  void* args[] = {static_cast<void*>(&dense), &p, &ids, &mom, &gmin, &gmax,
                  &faces, &ovf};
  return launch(is_int32, p.B, static_cast<int>(smem_bytes(L)), args, stream);
}

// dense as for ta_block_sweep. The plan (cap, hash bits, listed slots, ring
// stages with 0 for direct loads, tile box z/y/x, stage bytes, and the
// dynamic shared memory smem) comes from the caller. count int32 [B + 1]
// (allocated by the caller) gets each block's dictionary size, saturated at
// cap + 1, then the largest of them; ws int32 [2] is the caller's
// workspace for that largest count, zero before the first launch on a
// stream and left zero by every launch. A tile plan needs dense and its
// row pitch X * elsize at multiples of 16 bytes and a box of at most 256 a
// side, or it returns cudaErrorInvalidValue. Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
int ta_block_label_count(const void* dense, int is_int32, int Z, int Y, int X,
                         int bz, int by, int bx, int n, int cap, int hbits, int nlist,
                         int stages, int box_z, int box_y, int box_x, int stage_bytes,
                         int smem, void* count, void* ws, void* stream) {
  Params p = make_params(Z, Y, X, bz, by, bx, cap, n, hbits);
  if (p.B == 0) return 0;
  // the kernel's layout: ring at a 128-byte boundary, mbarriers, hash,
  // listed slots, 32 ints
  const long long layout = 128 + static_cast<long long>(stages) * (stage_bytes + 8) +
                           4LL * ((1LL << hbits) + nlist + 32);
  if (p.B >= (1LL << 31) || smem < layout) return static_cast<int>(cudaErrorInvalidValue);
  CountPlan c{cap, hbits, nlist, stages, box_z, box_y, box_x, stage_bytes};
  const long long es = is_int32 ? 4 : 2;
  CUtensorMap tmap;
  std::memset(&tmap, 0, sizeof(tmap));
  if (stages > 0) {
    if ((reinterpret_cast<uintptr_t>(dense) & 15) != 0 || (X * es) % 16 != 0 ||
        box_z < 1 || box_y < 1 || box_x < 1 || box_z > 256 || box_y > 256 || box_x > 256 ||
        (box_x * es) % 16 != 0 || stage_bytes % 128 != 0 ||
        stage_bytes < box_z * box_y * box_x * es)
      return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(X), static_cast<cuuint64_t>(Y),
                                static_cast<cuuint64_t>(Z)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(X * es),
                                   static_cast<cuuint64_t>(Y) * X * es};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_x), static_cast<cuuint32_t>(box_y),
                               static_cast<cuuint32_t>(box_z)};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = encode(
        &tmap, is_int32 ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_UINT16, 3,
        const_cast<void*>(dense), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {static_cast<void*>(&dense), &p, &c, &tmap, &count, &ws};
  return launch(2 + (stages > 0 ? 2 : 0) + is_int32, p.B, smem, args, stream);
}

}  // extern "C"
