// One-dimensional bulk asynchronous copy (the Tensor Memory Accelerator
// without a tensor map) from device memory into shared memory, with its
// completion reported to an mbarrier in shared memory. One lane asks for the
// whole copy; no thread spends registers or instructions on the bytes.
//
// Source, destination and size must be multiples of 16 bytes. A barrier is
// used by one warp here: initialised for one arrival (the lane that issues
// the copy), waited on by every lane with the parity of the copy's turn
// (0 for the first copy, then alternating).

#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t hgt_shared_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One lane, once; the warp synchronises before any lane uses the barrier.
__device__ __forceinline__ void hgt_mbarrier_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(hgt_shared_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One lane: copy `bytes` from device memory to shared memory; `bar` completes
// its current phase when they have all landed. Every lane of the warp has
// finished its reads of `dst` and the warp is synchronised.
__device__ __forceinline__ void hgt_bulk_copy(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
    const uint32_t b = hgt_shared_addr(bar);
    // order the warp's earlier generic-proxy accesses of dst before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(hgt_shared_addr(dst)), "l"(src), "r"(bytes), "r"(b)
        : "memory");
}

// Every lane: wait until the phase of parity `parity` has completed; the
// copied bytes are then visible to this lane.
__device__ __forceinline__ void hgt_mbarrier_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t b = hgt_shared_addr(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(b), "r"(parity)
            : "memory");
    } while (!done);
}
