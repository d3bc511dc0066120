// A kernel's opt-in to more than 48 KB of dynamic shared memory, set once
// per device.
//
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize)
// belongs to the device context it was set in. A flag kept once per
// process (a function-local `static` around the call) would leave a second
// card without the opt-in, and a launch there would be refused. So the
// (kernel, device) pairs already set are kept in a set behind a mutex; the
// first launch of a kernel on a device sets the attribute there.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <utility>

inline std::mutex g_smem_opt_in_mu;
inline std::set<std::pair<const void*, int>> g_smem_opted_in;

// Sets `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device unless that was done already; returns the cudaError_t of the call.
template <typename Kernel>
cudaError_t smem_opt_in(Kernel* kernel, int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel),
                                        device);
  std::lock_guard<std::mutex> lock(g_smem_opt_in_mu);
  if (g_smem_opted_in.count(key)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) g_smem_opted_in.insert(key);
  return err;
}
