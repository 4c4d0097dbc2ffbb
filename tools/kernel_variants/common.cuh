// Shared by the variant timers: an error check, the device time of one
// launch in a saturated stream, and the host time to enqueue one.
#pragma once
#include <chrono>
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

// host time to enqueue one call: 100 calls back to back, no sync between
// (fewer launches than the stream's queue holds)
template <class F>
double host_us(F launch) {
  launch(); CK(cudaDeviceSynchronize());
  const auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < 100; ++r) launch();
  const auto t1 = std::chrono::steady_clock::now();
  CK(cudaDeviceSynchronize());
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / 100;
}
