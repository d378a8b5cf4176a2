// K2 class_analysis: per-class junction verdict over the canonically sorted
// positions, for Hopper (sm_90a).
//
// Replaces the class analysis of sibeliaz_tpu/graph/construct.py::
// _v7_core_cummax2 (the production core; equal to _v7_core_scan's segmented
// OR). A class is a run of equal sorted keys; its OR is the bitwise OR of
// the packed words of its rows; the class is a junction when that OR holds
// two or more right extensions (bits 0-3), two or more left extensions
// (bits 5-8) or a run boundary (bit 10), and never for the invalid-window
// class (key 2^62). first[i] is the position at the class's start row.
//
// What bounds it: device memory, about 17 B read and 5 B written per row
// over three passes, plus atomics. torch has no segmented bitwise OR, and a
// thread that walks a class serially would stall on the hot classes
// (poly-A repeats give classes of 10^5-10^6 rows). The design:
//   1. mark_starts flags the rows whose key differs from the previous row;
//   2. the caller turns the flags into class numbers with torch.cumsum;
//   3. class_or reduces each warp's rows per class with a segmented shuffle
//      scan (a sorted class is contiguous), so one atomicOr per class per
//      warp reaches device memory: a class of a million rows costs 31,250
//      atomics, not a million. Rows of the invalid class are skipped. The
//      start row of each class also stores its position;
//   4. verdict reads each row's class word back and writes the verdict and
//      the class's first position.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr long long kInvalidCanon = 1LL << 62;

__global__ void mark_starts_kernel(const long long* __restrict__ key,
                                   long long n, int32_t* __restrict__ start) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) start[i] = (i == 0 || key[i] != key[i - 1]) ? 1 : 0;
}

// cls_incl[i] is the inclusive count of class starts up to row i, so row i
// belongs to class cls_incl[i] - 1.
__global__ void class_or_kernel(const long long* __restrict__ key,
                                const int32_t* __restrict__ packed,
                                const int32_t* __restrict__ pos,
                                const int32_t* __restrict__ cls_incl,
                                long long n, uint32_t* __restrict__ cls_or,
                                int32_t* __restrict__ cls_first) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const int cls = in ? cls_incl[i] - 1 : -1;
  uint32_t v = (in && key[i] != kInvalidCanon)
                   ? static_cast<uint32_t>(packed[i]) : 0u;
  if (in && (i == 0 || key[i] != key[i - 1])) cls_first[cls] = pos[i];

  // Suffix OR within each class's lanes: after the loop a lane holds the OR
  // of itself and every later lane of its class in this warp. All 32 lanes
  // take part; lanes past n carry class -1 and value 0.
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t ov = __shfl_down_sync(0xffffffffu, v, d);
    const int oc = __shfl_down_sync(0xffffffffu, cls, d);
    if (lane + d < 32 && oc == cls) v |= ov;
  }
  const int prev_cls = __shfl_up_sync(0xffffffffu, cls, 1);
  const bool leader = lane == 0 || prev_cls != cls;
  if (in && leader && v != 0u) atomicOr(&cls_or[cls], v);
}

__global__ void verdict_kernel(const long long* __restrict__ key,
                               const int32_t* __restrict__ cls_incl,
                               const uint32_t* __restrict__ cls_or,
                               const int32_t* __restrict__ cls_first,
                               long long n, uint8_t* __restrict__ junction,
                               int32_t* __restrict__ first) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int cls = cls_incl[i] - 1;
  const uint32_t w = cls_or[cls];
  const bool j = key[i] != kInvalidCanon &&
                 (__popc(w & 0xFu) > 1 || __popc((w >> 5) & 0xFu) > 1 ||
                  ((w >> 10) & 1u));
  junction[i] = j ? 1 : 0;
  first[i] = cls_first[cls];
}

unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

}  // namespace

// key_s: n int64 sorted keys; start: n int32 out. Returns cudaGetLastError().
extern "C" int sz_class_mark_starts(const void* key_s, long long n,
                                    void* start, void* stream) {
  if (n <= 0) return 0;
  mark_starts_kernel<<<grid_for(n), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key_s), n, static_cast<int32_t*>(start));
  return static_cast<int>(cudaGetLastError());
}

// cls_or must be zeroed, n int32; cls_first n int32. Returns
// cudaGetLastError().
extern "C" int sz_class_or(const void* key_s, const void* packed_s,
                           const void* pos_s, const void* cls_incl,
                           long long n, void* cls_or, void* cls_first,
                           void* stream) {
  if (n <= 0) return 0;
  class_or_kernel<<<grid_for(n), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key_s),
      static_cast<const int32_t*>(packed_s),
      static_cast<const int32_t*>(pos_s),
      static_cast<const int32_t*>(cls_incl), n,
      static_cast<uint32_t*>(cls_or), static_cast<int32_t*>(cls_first));
  return static_cast<int>(cudaGetLastError());
}

// junction: n uint8 out; first: n int32 out. Returns cudaGetLastError().
extern "C" int sz_class_verdict(const void* key_s, const void* cls_incl,
                                const void* cls_or, const void* cls_first,
                                long long n, void* junction, void* first,
                                void* stream) {
  if (n <= 0) return 0;
  verdict_kernel<<<grid_for(n), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key_s),
      static_cast<const int32_t*>(cls_incl),
      static_cast<const uint32_t*>(cls_or),
      static_cast<const int32_t*>(cls_first), n,
      static_cast<uint8_t*>(junction), static_cast<int32_t*>(first));
  return static_cast<int>(cudaGetLastError());
}
