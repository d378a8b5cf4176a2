// K7 lcb_step's split of a step: clock64 stamps around each part of a
// lane's step, summed for each lane, and a few counts beside them.  They
// exist only in a build with SZ_STEP_STAMPS defined (chip_smoke.py --step
// builds one beside the default library, cudabuild.load(("SZ_STEP_STAMPS",)));
// without it now() is 0 and add() and count() are empty, so the default
// build carries no stamps.  Thread 0 of a block takes every stamp: it
// meets each of the vote's barriers and runs the walk's pushes (warp 0,
// lane 0), so the time between two of its stamps is the block's.  The
// sums live in shared memory (kParts words, a block's own) and the kernel
// writes them out per lane at its end; K5's and K6's kernels, which run
// the same device code, sum into their own copy and never read it.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace stamps {

// the parts of a step (cycles), then the counts
enum Part {
  V_COLS,     // the vote's columns and path row: from the lane's slab to shared memory
  V_WINDOWS,  // the vote's windows (the table cleared, the slots, the inserts, a spill)
  V_WINNER,   // the winner: the scan of the occupied slots and the block minimum
  V_RETRY,    // the used-retry's second vote, whole
  W_LOAD,     // a walk's start: the slab in (bulk copies and their wait), the first edges
  W_TAILS,    // warp 0 waiting for the uniform tails
  W_PUSHES,   // the pushes, without their scores, stores and tail waits
  W_SCORES,   // the pushes' scores
  W_STORES,   // the slabs' stores and the wait for them at the walk's end
  REGISTERS,  // the protocol registers of a completed attempt
  REWIND,     // the forward sweep's rewind from the rewind slab
  TOTAL,      // the lane's whole run (the parts, its steps' decisions and barriers)
  C_VOTES,    // counts: votes,
  C_VOTERS,   // voting instances (summed over votes),
  C_ROUNDS,   // window rounds (a vote's largest count of rounds of a window group),
  C_RETRIES,  // used-retries,
  C_WALKS,    // walk chunks,
  C_BLOCK_SCORES,  // scores taken by the block (more than a warp's columns)
  W_WAITS,    // of the pushes and stores: waiting for earlier bulk stores
  W_OCC,      // of the pushes: their occurrence loops
  W_ISSUE,    // of the stores: the bulk copies' issue (after the registers and the fence)
  C_INSERTS,  // counts: instance inserts,
  C_BLOCK_SHIFTS,  // their shifts taken by the block (more than a warp's columns)
  NS_START,   // the block's start and end on the card's global timer, ns
  NS_END,
  SM,         // the SM the block ran on
  kParts
};

#ifdef SZ_STEP_STAMPS
constexpr bool kOn = true;
__shared__ long long acc[kParts];

__device__ __forceinline__ long long now() { return clock64(); }
// thread 0 adds the cycles since `since` to `part`
__device__ __forceinline__ void add(int part, long long since) {
  if (threadIdx.x == 0) acc[part] += clock64() - since;
}
__device__ __forceinline__ void count(int part, long long n) {
  if (threadIdx.x == 0) acc[part] += n;
}
__device__ __forceinline__ long long sum(int part) { return acc[part]; }
// thread 0 notes the global timer in `part`
__device__ __forceinline__ void mark(int part) {
  if (threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    acc[part] = static_cast<long long>(ns);
  }
}
// thread 0 notes the block's SM in `part`
__device__ __forceinline__ void mark_sm(int part) {
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    acc[part] = sm;
  }
}
// thread 0, before the block's first barrier
__device__ __forceinline__ void clear() {
  if (threadIdx.x == 0) {
    for (int p = 0; p < kParts; ++p) acc[p] = 0;
  }
}
#else
constexpr bool kOn = false;
__device__ __forceinline__ long long now() { return 0; }
__device__ __forceinline__ void add(int, long long) {}
__device__ __forceinline__ void count(int, long long) {}
__device__ __forceinline__ long long sum(int) { return 0; }
__device__ __forceinline__ void mark(int) {}
__device__ __forceinline__ void mark_sm(int) {}
__device__ __forceinline__ void clear() {}
#endif

}  // namespace stamps
}  // namespace
