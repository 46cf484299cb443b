// The grid-wide barrier of the persistent decode steps: K12
// (parler_flat.cu), K10 (dia_flat.cu) and the llama steps (llama_flat.cu,
// llama_flat_batched.cu), each one cooperative launch whose phases are
// separated by it. A cooperative launch refuses a grid
// that cannot be resident at once, so every block reaches every barrier.
//
// bar[0] counts arrivals over the whole launch and must be 0 when the
// launch starts: barrier k of the launch is passed once it reaches
// (k + 1) x the grid, and a block finds k from the count its own arrival
// returns. A block's thread 0 arrives with an add of acquire-release
// semantics at device scope (its block's writes, ordered before it by the
// block barrier, become visible with it) and polls the count with acquire
// loads; the poll gives up with a trap after about ten seconds rather than
// hang. One add and one poll a block, where the barrier before it (a
// counter reset by the last block to arrive, then a generation word bumped
// for the others) took two round trips after the last arrival: K12's step
// fell from 1.44 to 1.25 ms with it (gemv_ab, PERF.md). grid_exit leaves
// the words zeroed for the next launch on the stream (bar[1] counts the
// blocks that have left); a launch whose words are zeroed before it needs
// no grid_exit.
#pragma once

#include <cuda_runtime.h>

namespace tts {

constexpr long long GRID_SPIN_LIMIT = 20000000000LL;  // clock cycles, ~10 s

__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(bar)
                 : "memory");
    const unsigned int target = (old / gridDim.x + 1) * gridDim.x;
    unsigned int seen = old + 1;
    const long long t0 = clock64();
    while (seen < target) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
      if (clock64() - t0 > GRID_SPIN_LIMIT) __trap();
    }
  }
  __syncthreads();
}

// Until *count reaches target (thread 0 polls with acquire loads, giving up
// with a trap after about ten seconds), then a block barrier: what the
// writers fenced before they counted is visible to the whole block. K12
// waits so for the tiles of one head instead of a grid barrier.
__device__ __forceinline__ void wait_count(const unsigned int* count,
                                           unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int seen;
    const long long t0 = clock64();
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if (seen >= target) break;
      if (clock64() - t0 > GRID_SPIN_LIMIT) __trap();
    }
  }
  __syncthreads();
}

// After a block's last barrier: the last block of the grid to leave zeroes
// both words (every other block has passed every barrier by then).
__device__ __forceinline__ void grid_exit(unsigned int* bar) {
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
    bar[0] = 0u;
    bar[1] = 0u;
  }
}

}  // namespace tts
