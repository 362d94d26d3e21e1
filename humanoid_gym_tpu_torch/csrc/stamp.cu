// The stage tracer's timestamp (humanoid_gym_tpu_torch/utils/tracing.py).
//
// Replaces no TPU kernel: the JAX package traces its iteration with
// jax.profiler and names no stage inside it. A CUDA graph replay runs no
// Python, so a stage boundary inside the captured training iteration is
// marked by a kernel of its own: one thread reads the card's %globaltimer
// (nanoseconds) and writes it into buf[slot]. Launched on the caller's
// stream, it runs after the stream's earlier work and before its later
// work; launched while a graph is captured, it becomes a node of the graph
// and every replay writes the slot anew. Bound by its launch (one 8-byte
// store): the cost of a stamp is the graph node's, about a microsecond.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void hgt_stamp(uint64_t* buf, int slot) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    buf[slot] = t;
}

extern "C" int hgt_stamp_launch(void* buf, int slot, void* stream) {
    hgt_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint64_t*>(buf), slot);
    return static_cast<int>(cudaGetLastError());
}
