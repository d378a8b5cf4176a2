// K1 front_half: the per-position front half of junction enumeration, for
// Hopper (sm_90a).
//
// Replaces sibeliaz_tpu/graph/pallas_kernels.py::canon_packed (the Pallas
// kernel) together with the XLA program it fuses,
// sibeliaz_tpu/graph/construct.py::_prepare_packed with unpack_codes_device,
// _windowed_all and _doubling_codes.
//
// For every position p of the separator-joined genome it emits
//   key[p]    = min(fwd, rc) of the k-window at p, or 2^62 where the window
//               is not all ACGT or runs past the end (sorts after every code,
//               since 4^31 - 1 < 2^62);
//   packed[p] = bits 0-4 right-extension presence (bit 4 = none),
//               bits 5-9 left-extension presence, bit 10 run boundary,
//               bit 11 forward orientation is canonical.
// Windows past the end read the sequence cyclically, as the rolls of the XLA
// form do, so bit 11 of an invalid window is the same in both.
//
// What bounds it: device memory, about 0.4 B read (2-bit codes plus a 1-bit
// validity map) and 12 B written per position, while the arithmetic is k
// shift-or steps on 64-bit words per position. The design: a block stages
// its 256 positions plus a halo of k + 1 into shared memory as one byte each
// (code | definite << 2), so each packed input byte is read once per block;
// each thread then walks its own window out of shared memory. The TPU
// kernel's (hi, lo) int32 split and its sign-flip compare are gone: the GPU
// has native 64-bit integers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxK = 31;
constexpr int kNoExt = 4;
constexpr long long kInvalidCanon = 1LL << 62;

__global__ void front_half_kernel(const uint8_t* __restrict__ codes2,
                                  const uint8_t* __restrict__ nmask,
                                  long long n, int k,
                                  long long* __restrict__ key,
                                  int32_t* __restrict__ packed) {
  // s[j] describes position b0 - 1 + j: bits 0-1 code (0 where not
  // definite), bit 2 definite.
  __shared__ uint8_t s[kBlock + kMaxK + 1];
  const long long b0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int span = kBlock + k + 1;
  for (int j = threadIdx.x; j < span; j += kBlock) {
    long long q = b0 - 1 + j;
    if (q < 0 || q >= n) q = ((q % n) + n) % n;
    const int c = (codes2[q >> 2] >> ((q & 3) * 2)) & 3;
    const int d = (nmask[q >> 3] >> (q & 7)) & 1;
    s[j] = d ? static_cast<uint8_t>(c | 4) : 0;
  }
  __syncthreads();

  const long long p = b0 + threadIdx.x;
  if (p >= n) return;
  const uint8_t* w = s + threadIdx.x + 1;  // w[i] is position p + i

  unsigned long long fwd = 0, rc = 0;
  bool inner = true;  // positions p+1 .. p+k-2 are all definite
  for (int i = 0; i < k; ++i) {
    const unsigned long long c = w[i] & 3;
    fwd = (fwd << 2) | c;
    rc |= (3ull - c) << (2 * i);
    if (i >= 1 && i <= k - 2) inner = inner && (w[i] & 4);
  }
  const bool d_prev = w[-1] & 4, d_first = w[0] & 4;
  const bool d_last = w[k - 1] & 4, d_next = w[k] & 4;
  const bool valid = d_first && inner && d_last && p + k <= n;
  const bool prev_valid =
      p >= 1 && d_prev && d_first && inner && p - 1 + k <= n;
  const bool next_valid = inner && d_last && d_next && p + 1 + k <= n;
  const bool boundary = valid && !(prev_valid && next_valid);

  const bool positive = fwd < rc;
  const bool nxt_ok = d_next && p + k < n;
  const bool prv_ok = d_prev && p >= 1;
  const int nxt = w[k] & 3, prv = w[-1] & 3;
  const int right = positive ? (nxt_ok ? nxt : kNoExt)
                             : (prv_ok ? 3 - prv : kNoExt);
  const int left = positive ? (prv_ok ? prv : kNoExt)
                            : (nxt_ok ? 3 - nxt : kNoExt);

  packed[p] = (1 << right) | (1 << (left + 5)) | (int(boundary) << 10) |
              (int(positive) << 11);
  key[p] = valid ? static_cast<long long>(fwd < rc ? fwd : rc)
                 : kInvalidCanon;
}

}  // namespace

// codes2: ceil(n/4) bytes of 2-bit codes, four per byte, low bits first;
// nmask: ceil(n/8) bytes of definiteness, eight per byte, low bit first;
// key: n int64; packed: n int32. 1 <= k <= 31. Returns cudaGetLastError().
extern "C" int sz_front_half(const void* codes2, const void* nmask,
                             long long n, int k, void* key, void* packed,
                             void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kBlock - 1) / kBlock;
  front_half_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes2), static_cast<const uint8_t*>(nmask),
      n, k, static_cast<long long*>(key), static_cast<int32_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}
