// ipc.cuh: the CUDA IPC entries of csrc/ring_all_reduce.cu (kernel 8) and
// csrc/bidir_ring.cu (kernel 9), for ranks that live in several processes.
//
// A process cannot address another process's memory until the owner exports
// it and the reader maps it: the owner allocates with cudaMalloc (an IPC
// handle names a whole allocation, so the wrappers allocate these buffers
// here and never hand out blocks of PyTorch's caching allocator), takes its
// cudaIpcMemHandle_t (64 bytes, sent to the other processes over the host),
// and each reader opens it with cudaIpcOpenMemHandle, lazily enabling peer
// access when the memory lies on another card.  What travels through these
// mappings is the collectives' own traffic: on one card the one-shot reads
// the other processes' staged inputs (oneshot.cuh), on several cards the ring
// protocol stores into the neighbours' slots and flags (ring.cuh, with
// system-scope fences).  Nothing is copied through the host.
#pragma once

#include <cuda_runtime.h>
#include <string.h>

namespace ipc {

constexpr int kHandleBytes = static_cast<int>(sizeof(cudaIpcMemHandle_t));

// `bytes` of device memory on the current card, zeroed (flags start at 0).
inline int alloc(long long bytes, void** ptr) {
  cudaError_t e = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}

inline int free_(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// The handle of the allocation at `ptr` into out[kHandleBytes].
inline int handle(void* ptr, char* out) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(out, &h, sizeof(h));
  return static_cast<int>(e);
}

// Map another process's allocation (its handle in in[kHandleBytes]).
inline int open(const char* in, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, in, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

inline int close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// A device-to-device copy on `stream` (a rank's input into its staging).
inline int copy(void* dst, const void* src, long long bytes, void* stream) {
  return static_cast<int>(cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes),
                                          cudaMemcpyDeviceToDevice,
                                          static_cast<cudaStream_t>(stream)));
}

}  // namespace ipc

// NAME_ipc_alloc / _free / _handle / _open / _close / _copy (for ctypes).
#define IPC_C_ENTRIES(NAME)                                                   \
  extern "C" int NAME##_ipc_alloc(long long bytes, void** ptr) {              \
    return ipc::alloc(bytes, ptr);                                            \
  }                                                                           \
  extern "C" int NAME##_ipc_free(void* ptr) { return ipc::free_(ptr); }       \
  extern "C" int NAME##_ipc_handle(void* ptr, char* out) {                    \
    return ipc::handle(ptr, out);                                             \
  }                                                                           \
  extern "C" int NAME##_ipc_open(const char* in, void** ptr) {                \
    return ipc::open(in, ptr);                                                \
  }                                                                           \
  extern "C" int NAME##_ipc_close(void* ptr) { return ipc::close(ptr); }      \
  extern "C" int NAME##_ipc_copy(void* dst, const void* src, long long bytes, \
                                 void* stream) {                              \
    return ipc::copy(dst, src, bytes, stream);                                \
  }
