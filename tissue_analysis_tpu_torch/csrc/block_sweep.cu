// Fused per-block sweep of a dense-relabeled 3D stack (Hopper, sm_90a).
//
// Replaces both TPU kernels of tissue_analysis_tpu/ops/pallas_block.py,
// which share one per-block contract:
//   - _kernel_factory_v2 (kernel-v2): block 8x16x128, n < 2^16;
//   - _kernel_factory (kernel-v1): any block shape and label count. It
//     carries every 2D image (lifted to [1, Y, X], block 1x128x128) and
//     every label space with n >= 2^16 (int32 labels).
// The TPU's workarounds are not carried over: bf16 one-hot MXU dots, 8-bit
// value splits, hi/lo split columns, the hashed min/max dictionary chain,
// extras plane packing, and v1's three globally shifted neighbour copies
// with its local lo/hi moments rebuilt afterwards in XLA. This card has
// int64 and shared-memory atomics, and reads the neighbours in place.
//
// One CUDA block per voxel block of shape (bz, by, bx) (runtime arguments:
// 8x16x128 for 3D, 1x128x128 for a lifted 2D image), in z-major block
// order. Coordinates past the stack's
// extent read as the dropped label n, so no padded copy of the stack exists.
// Per block:
//   1. dictionary: the distinct labels < n of the block's voxels and of the
//      +1 z/y/x neighbours just past its far faces (read from global
//      memory), collected in a shared open-addressing hash, then ranked so
//      slots hold ascending ids (IMAX in empty slots). More than L distinct
//      labels sets ovf[b]; the rest of that block's outputs is then
//      undefined and the caller reruns with a larger L.
//   2. per slot: count, sum z/y/x and the six sum c_i*c_j in LOCAL
//      coordinates (int32 shared atomics; K * (extent-1)^2 < 2^31 is checked
//      by the wrapper), bbox min/max; globalized once per slot in int64.
//   3. faces[slot(a), d*L + slot(b)] += 1 for every voxel labelled a < n
//      whose +1 neighbour along axis d is labelled b < n, b != a (so the
//      same-label diagonal is zero by construction).
//
// What bounds it on this card: it reads 2 bytes per voxel (uint16 input,
// ~0.27 GB at 512^3) once from HBM plus neighbour re-reads that hit L1/L2,
// so the memory floor is well under a millisecond. The likely limit is
// contention of shared-memory atomics on the few hot slots of a block (a
// warp's lanes mostly share one label). This first design does nothing
// about that yet beyond caching the last hash lookup per thread;
// warp-aggregated atomics are later work.
//
// Two face paths, picked at launch (template flag kFacesGlobal):
//   - shared: the [L, 3L] face matrix sits in shared memory and is copied
//     out once. L = 128 takes ~207 KB and one block per SM; L above ~135
//     does not fit.
//   - global: for such L the face atomics go straight to the block's own
//     [L, 3L] slice of faces_out, which the caller zeroes first. Shared
//     memory then holds only the hash, the local moments and the bbox
//     (2H + 16L + 2 ints), which fits up to L ~ 2600. Dense label spaces
//     (4^3-voxel cells: ~456 dictionary labels per 8x16x128 block) take
//     this path; its cost is the dense B * 3L^2 face output itself.
// The rank step is O(H^2 / threads), H = 2L rounded up to a power of two:
// at L = 512 that is 1024^2 / 512 = 2,048 compares a thread; at L = 2048
// (H = 4096) 32,768, which is what bounds the global path in time before
// shared memory bounds it in size.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIMax = 0x7fffffff;
constexpr int kEmpty = -1;
constexpr int kThreads = 512;

struct Params {
  int Z, Y, X;
  int bz, by, bx;
  int gy, gx;
  int L, n, hbits;
};

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

template <typename T>
__device__ __forceinline__ int load_label(const T* __restrict__ dense,
                                          int64_t g) {
  return static_cast<int>(__ldg(dense + g));
}

// a label takes part iff 0 <= v < n (unsigned compare)
__device__ __forceinline__ bool live(int v, int n) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(n);
}

template <typename T, bool kFacesGlobal>
__global__ void __launch_bounds__(kThreads)
block_sweep_kernel(const T* __restrict__ dense, Params p,
                   int* __restrict__ ids_out, long long* __restrict__ mom_out,
                   int* __restrict__ gmin_out, int* __restrict__ gmax_out,
                   int* __restrict__ faces_out, int* __restrict__ ovf_out) {
  extern __shared__ int smem[];
  const int L = p.L;
  const int n = p.n;
  const int H = 1 << p.hbits;
  int* hkeys = smem;            // [H]
  int* hslot = hkeys + H;       // [H]
  int* acc = hslot + H;         // [L, 10] local moments
  int* bmin = acc + 10 * L;     // [L, 3]
  int* bmax = bmin + 3 * L;     // [L, 3]
  const int64_t b = blockIdx.x;
  // [L, 3L] face counts: shared, or this block's slice of faces_out
  int* fc = kFacesGlobal ? faces_out + b * 3 * L * L : bmax + 3 * L;
  // ndistinct, full
  int* misc = kFacesGlobal ? bmax + 3 * L : bmax + 3 * L + 3 * L * L;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int bxi = static_cast<int>(b % p.gx);
  const int byi = static_cast<int>((b / p.gx) % p.gy);
  const int bzi = static_cast<int>(b / (static_cast<int64_t>(p.gx) * p.gy));
  const int oz = bzi * p.bz, oy = byi * p.by, ox = bxi * p.bx;
  const int64_t sy = p.X;
  const int64_t sz = static_cast<int64_t>(p.Y) * p.X;
  const int K = p.bz * p.by * p.bx;
  const int byx = p.by * p.bx;

  for (int i = tid; i < H; i += nt) {
    hkeys[i] = kEmpty;
    hslot[i] = -1;
  }
  for (int i = tid; i < 10 * L; i += nt) acc[i] = 0;
  for (int i = tid; i < 3 * L; i += nt) {
    bmin[i] = kIMax;
    bmax[i] = -1;
  }
  if (!kFacesGlobal) {
    for (int i = tid; i < 3 * L * L; i += nt) fc[i] = 0;
  }
  if (tid == 0) {
    misc[0] = 0;
    misc[1] = 0;
  }
  __syncthreads();

  // ---- 1. dictionary: the block's voxels ...
  int last = kEmpty;
  for (int i = tid; i < K; i += nt) {
    const int lx = i % p.bx;
    const int ly = (i / p.bx) % p.by;
    const int lz = i / byx;
    const int z = oz + lz, y = oy + ly, x = ox + lx;
    if (z >= p.Z || y >= p.Y || x >= p.X) continue;
    const int v = load_label(dense, z * sz + y * sy + x);
    if (live(v, n) && v != last) {
      dict_insert(hkeys, v, p.hbits, &misc[0], &misc[1]);
      last = v;
    }
  }
  // ... and the +1 neighbours past its far z, y and x faces (a neighbour
  // label absent from the block itself still needs a slot, or its face
  // pair would vanish)
  if (oz + p.bz < p.Z) {
    const int z = oz + p.bz;
    for (int i = tid; i < byx; i += nt) {
      const int y = oy + i / p.bx, x = ox + i % p.bx;
      if (y >= p.Y || x >= p.X) continue;
      const int v = load_label(dense, z * sz + y * sy + x);
      if (live(v, n)) dict_insert(hkeys, v, p.hbits, &misc[0], &misc[1]);
    }
  }
  if (oy + p.by < p.Y) {
    const int y = oy + p.by;
    for (int i = tid; i < p.bz * p.bx; i += nt) {
      const int z = oz + i / p.bx, x = ox + i % p.bx;
      if (z >= p.Z || x >= p.X) continue;
      const int v = load_label(dense, z * sz + y * sy + x);
      if (live(v, n)) dict_insert(hkeys, v, p.hbits, &misc[0], &misc[1]);
    }
  }
  if (ox + p.bx < p.X) {
    const int x = ox + p.bx;
    for (int i = tid; i < p.bz * p.by; i += nt) {
      const int z = oz + i / p.by, y = oy + i % p.by;
      if (z >= p.Z || y >= p.Y) continue;
      const int v = load_label(dense, z * sz + y * sy + x);
      if (live(v, n)) dict_insert(hkeys, v, p.hbits, &misc[0], &misc[1]);
    }
  }
  __syncthreads();

  // ---- rank: slot = number of smaller keys, so slots ascend by id
  const int nd = misc[0];
  if (tid == 0) ovf_out[b] = (nd > L || misc[1]) ? 1 : 0;
  for (int h = tid; h < H; h += nt) {
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
  for (int s = nd + tid; s < L; s += nt) ids_out[b * L + s] = kIMax;
  __syncthreads();

  // ---- 2+3. moments, bbox and faces
  int last_v = kEmpty, last_s = -1;
  for (int i = tid; i < K; i += nt) {
    const int lx = i % p.bx;
    const int ly = (i / p.bx) % p.by;
    const int lz = i / byx;
    const int z = oz + lz, y = oy + ly, x = ox + lx;
    if (z >= p.Z || y >= p.Y || x >= p.X) continue;
    const int64_t g = z * sz + y * sy + x;
    const int a = load_label(dense, g);
    if (!live(a, n)) continue;
    if (a != last_v) {
      last_v = a;
      last_s = dict_slot(hkeys, hslot, a, p.hbits);
    }
    const int s = last_s;
    if (s < 0) continue;
    int* m = acc + 10 * s;
    atomicAdd(&m[0], 1);
    atomicAdd(&m[1], lz);
    atomicAdd(&m[2], ly);
    atomicAdd(&m[3], lx);
    atomicAdd(&m[4], lz * lz);
    atomicAdd(&m[5], lz * ly);
    atomicAdd(&m[6], lz * lx);
    atomicAdd(&m[7], ly * ly);
    atomicAdd(&m[8], ly * lx);
    atomicAdd(&m[9], lx * lx);
    atomicMin(&bmin[3 * s + 0], lz);
    atomicMin(&bmin[3 * s + 1], ly);
    atomicMin(&bmin[3 * s + 2], lx);
    atomicMax(&bmax[3 * s + 0], lz);
    atomicMax(&bmax[3 * s + 1], ly);
    atomicMax(&bmax[3 * s + 2], lx);

    int* row = fc + 3 * L * s;
    if (z + 1 < p.Z) {
      const int c = load_label(dense, g + sz);
      if (c != a && live(c, n)) {
        const int t = dict_slot(hkeys, hslot, c, p.hbits);
        if (t >= 0) atomicAdd(&row[t], 1);
      }
    }
    if (y + 1 < p.Y) {
      const int c = load_label(dense, g + sy);
      if (c != a && live(c, n)) {
        const int t = dict_slot(hkeys, hslot, c, p.hbits);
        if (t >= 0) atomicAdd(&row[L + t], 1);
      }
    }
    if (x + 1 < p.X) {
      const int c = load_label(dense, g + 1);
      if (c != a && live(c, n)) {
        const int t = dict_slot(hkeys, hslot, c, p.hbits);
        if (t >= 0) atomicAdd(&row[2 * L + t], 1);
      }
    }
  }
  __syncthreads();

  // ---- globalize once per slot, in int64:
  // sum c_g = s_c + C*o_c;  S_ij,g = S_ij + o_i*s_j + o_j*s_i + C*o_i*o_j
  const long long o[3] = {oz, oy, ox};
  for (int s = tid; s < L; s += nt) {
    const int* m = acc + 10 * s;
    const long long C = m[0];
    const long long s1[3] = {m[1], m[2], m[3]};
    long long* out = mom_out + (b * L + s) * 10;
    out[0] = C;
    for (int d = 0; d < 3; ++d) out[1 + d] = s1[d] + C * o[d];
    // tri_pairs order: zz, zy, zx, yy, yx, xx
    const int pi[6] = {0, 0, 0, 1, 1, 2};
    const int pj[6] = {0, 1, 2, 1, 2, 2};
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
  if (!kFacesGlobal) {
    int* fout = faces_out + b * 3 * L * L;
    for (int i = tid; i < 3 * L * L; i += nt) fout[i] = fc[i];
  }
}

int hash_bits(int L) {
  int bits = 6;  // at least 64 entries, and at least 2L (load <= 1/2)
  while ((1 << bits) < 2 * L) ++bits;
  return bits;
}

template <typename T, bool kFacesGlobal>
cudaError_t launch(const void* dense, const Params& p, unsigned B, size_t smem,
                   cudaStream_t st, void* ids, void* mom, void* gmin,
                   void* gmax, void* faces, void* ovf) {
  cudaError_t err = cudaFuncSetAttribute(
      block_sweep_kernel<T, kFacesGlobal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  block_sweep_kernel<T, kFacesGlobal><<<B, kThreads, smem, st>>>(
      static_cast<const T*>(dense), p, static_cast<int*>(ids),
      static_cast<long long*>(mom), static_cast<int*>(gmin),
      static_cast<int*>(gmax), static_cast<int*>(faces),
      static_cast<int*>(ovf));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block needs at dictionary size L, with
// the face matrix in shared memory (faces_global == 0) or in faces_out.
long long ta_block_sweep_smem_bytes(int L, int faces_global) {
  const long long H = 1LL << hash_bits(L);
  const long long fc = faces_global ? 0 : 3LL * L * L;
  return (2 * H + 16LL * L + fc + 2) * static_cast<long long>(sizeof(int));
}

// dense: [Z, Y, X] uint16 (is_int32 == 0) or int32, contiguous, on the device.
// Outputs (allocated by the caller; every element written here, except that
// with faces_global != 0 the kernel adds into faces, which the caller must
// have zeroed on the same stream):
//   ids int32 [B, L], mom int64 [B, L, 10], gmin/gmax int32 [B, L, 3],
//   faces int32 [B, L, 3L], ovf int32 [B].
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
int ta_block_sweep(const void* dense, int is_int32, int Z, int Y, int X,
                   int bz, int by, int bx, int L, int n, int faces_global,
                   void* ids, void* mom, void* gmin, void* gmax, void* faces,
                   void* ovf, void* stream) {
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
  p.L = L;
  p.n = n;
  p.hbits = hash_bits(L);
  const long long B = static_cast<long long>(gz) * p.gy * p.gx;
  if (B == 0) return 0;
  const size_t smem =
      static_cast<size_t>(ta_block_sweep_smem_bytes(L, faces_global));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(B);
  cudaError_t err;
  if (is_int32) {
    err = faces_global
              ? launch<int, true>(dense, p, nb, smem, st, ids, mom, gmin, gmax,
                                  faces, ovf)
              : launch<int, false>(dense, p, nb, smem, st, ids, mom, gmin,
                                   gmax, faces, ovf);
  } else {
    err = faces_global
              ? launch<unsigned short, true>(dense, p, nb, smem, st, ids, mom,
                                             gmin, gmax, faces, ovf)
              : launch<unsigned short, false>(dense, p, nb, smem, st, ids,
                                              mom, gmin, gmax, faces, ovf);
  }
  return static_cast<int>(err);
}

}  // extern "C"
