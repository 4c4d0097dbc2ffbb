// Shared by the variant timers: an error check, and the device time of one
// launch in a saturated stream.
#pragma once
#include <cstdio>
#include <vector>
#include <random>
#include <cuda_runtime.h>

#define CK(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) { \
  printf("{\"error\": \"%s\", \"line\": %d}\n", cudaGetErrorString(e_), __LINE__); exit(1);} } while (0)

__global__ void k_spin(long long cycles) {
  long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
}

// device time of one launch in a saturated stream: a spin kernel backs up
// the queue, then `reps` launches are enqueued behind it
template <class F>
float device_us(F launch, int reps = 100) {
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a)); CK(cudaEventCreate(&b));
  launch(); CK(cudaDeviceSynchronize());
  float best = 1e30f;
  for (int trial = 0; trial < 5; ++trial) {
    k_spin<<<1, 1>>>(4000000LL);   // ~2 ms
    CK(cudaEventRecord(a));
    for (int r = 0; r < reps; ++r) launch();
    CK(cudaEventRecord(b));
    CK(cudaEventSynchronize(b));
    float ms; CK(cudaEventElapsedTime(&ms, a, b));
    if (ms < best) best = ms;
  }
  CK(cudaGetLastError());
  return best * 1000.0f / reps;
}
