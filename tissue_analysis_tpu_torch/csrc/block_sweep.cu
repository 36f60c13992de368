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
// step alone and writes each block's dictionary size, so that a caller
// picks the sweep's L (or no block sweep at all) before the sweep.
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
#include <mutex>
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

// The dictionary pass of block_sweep_kernel alone (no TPU counterpart: it
// stands where the reference's engine catches a failed sweep and falls back
// to another engine). count[b] is the number of distinct labels < n among
// block b's voxels and the +1 z/y/x neighbours just past its far faces
// (step 1 of the contract above), saturated at cap + 1, so count[b] > L
// exactly where a sweep at L sets ovf[b], for every L <= cap. The hash has
// at least 2 (cap + 1) slots; a block stops inserting once its count passes
// cap (a block of 16,384 distinct labels would otherwise probe a full table
// on every insert), so the table can fill only past cap.
// What bounds it: the bytes of the stack and of its far-face planes, read
// once (x ~1.2 at the default block), and 4 B a block written. It reads
// through L1 as the sweep's first step does; no tensor-core work.
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_label_count_kernel(const T* __restrict__ dense, Params p, int cap,
                         int* __restrict__ count_out) {
  extern __shared__ int smem[];
  const int n = p.n;
  const int H = 1 << p.hbits;
  int* hkeys = smem;       // [H]
  int* misc = hkeys + H;   // ndistinct, full
  const volatile int* nd = misc;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = p.chunk;
  const long long sz = static_cast<long long>(p.Y) * p.X;

  for (long long b = blockIdx.x; b < p.B; b += gridDim.x) {
    const Geo g = block_geo(p, b);
    const T* base = dense + g.oz * sz + static_cast<long long>(g.oy) * p.X + g.ox;
    auto row = [&](int lz, int ly) {
      return base + lz * sz + static_cast<long long>(ly) * p.X;
    };
    const int npass = (g.ex + 32 * chunk - 1) / (32 * chunk);
    for (int i = tid; i < H; i += kThreads) hkeys[i] = kEmpty;
    if (tid == 0) {
      misc[0] = 0;
      misc[1] = 0;
    }
    __syncthreads();

    // the rows and the +x column of block_sweep_kernel's step 1; a warp
    // stops (all lanes at once) when the count has passed cap
    {
      int last = kEmpty;
      bool over = false;
      for (int ly = warp; ly < g.ty && !over; ly += kWarps) {
        for (int pass = 0; pass < npass && !over; ++pass) {
          const int x0 = (pass * 32 + lane) * chunk;
          for (int lz = 0; lz < g.tz; ++lz) {
            if (lz == p.bz && ly == p.by) continue;  // never a neighbour
            over = __any_sync(kFull, *nd > cap);
            if (over) break;
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
        if (!over && lane == 0 && g.tx > g.ex && ly < g.ey) {
          for (int lz = 0; lz < g.ez && *nd <= cap; ++lz) {
            const int v = __ldg(row(lz, ly) + g.ex);
            if (live(v, n)) dict_insert(hkeys, v, p.hbits, &misc[0], &misc[1]);
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) count_out[b] = (misc[0] > cap || misc[1]) ? cap + 1 : misc[0];
    __syncthreads();
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

// bytes of the count kernel's shared state: hash of >= 2 (cap + 1) slots,
// two counters
long long count_smem_bytes(int cap) {
  return ((1LL << hash_bits(cap + 1)) + 2) * static_cast<long long>(sizeof(int));
}

// ---------------------------------------------------------------- host side
enum Kind { kSweep = 0, kCount = 1 };

const void* kernel_of(int kind, int is_int32) {
  if (kind == kCount) {
    return is_int32
               ? reinterpret_cast<const void*>(&block_label_count_kernel<int>)
               : reinterpret_cast<const void*>(&block_label_count_kernel<unsigned short>);
  }
  return is_int32
             ? reinterpret_cast<const void*>(&block_sweep_kernel<int>)
             : reinterpret_cast<const void*>(&block_sweep_kernel<unsigned short>);
}

// per kernel and instantiation (2 * kind + is_int32), a bit per device
// whose attribute is set
std::atomic<unsigned long long> g_attr_set[4];
std::mutex g_cache_mu;
int g_sms[kMaxDevices];
struct OccEntry {
  int dev, fn, smem, ctas;
};
OccEntry g_occ[64];
int g_nocc = 0;

// The SMs of device dev and the CTAs an SM holds at smem bytes. Sets the
// dynamic shared-memory ceiling of the instantiation once per device; both
// answers are cached.
cudaError_t occupancy(int dev, int kind, int is_int32, int smem, int* ctas, int* sms) {
  const int fn = 2 * kind + is_int32;
  const unsigned long long bit = 1ULL << dev;
  if (!(g_attr_set[fn].load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of(kind, is_int32), cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
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
      ctas, kernel_of(kind, is_int32), kThreads, static_cast<size_t>(smem));
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

// Persistent CTAs of kernel (kind, is_int32): as many as fit an SM at smem
// bytes times the SMs, no more than the blocks. Returns cudaGetLastError().
int launch(int kind, int is_int32, long long B, int smem, void** args, void* stream) {
  int dev = 0, ctas = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  err = occupancy(dev, kind, is_int32, smem, &ctas, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = static_cast<long long>(ctas) * sms;
  const unsigned grid = static_cast<unsigned>(B < want ? B : want);
  err = cudaLaunchKernel(kernel_of(kind, is_int32), dim3(grid), dim3(kThreads), args,
                         static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  return launch(kSweep, is_int32, p.B, static_cast<int>(smem_bytes(L)), args, stream);
}

// Dynamic shared memory (bytes) of one block's state in the count kernel.
long long ta_block_label_count_smem_bytes(int cap) { return count_smem_bytes(cap); }

// dense as for ta_block_sweep; count int32 [B] (allocated by the caller) gets
// each block's dictionary size, saturated at cap + 1. Launches on `stream`,
// does not synchronise; returns cudaGetLastError().
int ta_block_label_count(const void* dense, int is_int32, int Z, int Y, int X,
                         int bz, int by, int bx, int cap, int n, void* count,
                         void* stream) {
  Params p = make_params(Z, Y, X, bz, by, bx, cap, n, hash_bits(cap + 1));
  if (p.B == 0) return 0;
  void* args[] = {static_cast<void*>(&dense), &p, &cap, &count};
  return launch(kCount, is_int32, p.B, static_cast<int>(count_smem_bytes(cap)), args,
                stream);
}

}  // extern "C"
