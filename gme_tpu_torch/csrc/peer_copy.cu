// Copies between cards for `utils/compiled.py`'s collective steps: a split
// entry (the band program across cards) runs each step's copies in groups
// by (source card, target card), all of a step's groups in one call.  A
// group within one card is plain device-to-device copies on its stream.  A
// group between two cards is one event pair: an event recorded on the source
// card's stream that the target card's stream waits on, the group's raw peer
// copies on the target's stream, and an event recorded after them that the
// source's stream waits on (its next work overwrites the copies' sources).
// Nothing here is a port of a TPU kernel: it is the counterpart of the
// copies XLA makes for a collective between shards.
#include "gme_kernels.cuh"

// Let `device` read and write `peer`'s memory, so that copies between them
// go straight over the link.  Enabled already counts as success.  The
// calling thread's current device is left as it was.
GME_API int gme_enable_peer(int device, int peer) {
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // not sticky: clear it
    err = cudaSuccess;
  }
  cudaError_t back = cudaSetDevice(current);
  return err != cudaSuccess ? err : back;
}

static cudaError_t run_groups(int n_groups, const int* group_src, const int* group_dst,
                              const int* group_count, void* const* sent, void* const* done,
                              void* const* dsts, const void* const* srcs, const size_t* bytes,
                              void* const* streams) {
  int c = 0;
  for (int g = 0; g < n_groups; ++g) {
    const int s = group_src[g], d = group_dst[g];
    cudaStream_t src_stream = static_cast<cudaStream_t>(streams[s]);
    cudaStream_t dst_stream = static_cast<cudaStream_t>(streams[d]);
    cudaEvent_t sent_g = static_cast<cudaEvent_t>(sent[g]);
    cudaEvent_t done_g = static_cast<cudaEvent_t>(done[g]);
    cudaError_t err;
    if (s != d) {
      if ((err = cudaSetDevice(s)) != cudaSuccess) return err;
      if ((err = cudaEventRecord(sent_g, src_stream)) != cudaSuccess) return err;
    }
    if ((err = cudaSetDevice(d)) != cudaSuccess) return err;
    if (s != d && (err = cudaStreamWaitEvent(dst_stream, sent_g, 0)) != cudaSuccess) return err;
    for (int i = 0; i < group_count[g]; ++i, ++c) {
      err = s != d ? cudaMemcpyPeerAsync(dsts[c], d, srcs[c], s, bytes[c], dst_stream)
                   : cudaMemcpyAsync(dsts[c], srcs[c], bytes[c], cudaMemcpyDeviceToDevice,
                                     dst_stream);
      if (err != cudaSuccess) return err;
    }
    if (s != d) {
      if ((err = cudaEventRecord(done_g, dst_stream)) != cudaSuccess) return err;
      if ((err = cudaSetDevice(s)) != cudaSuccess) return err;
      if ((err = cudaStreamWaitEvent(src_stream, done_g, 0)) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// One collective step: `n_groups` groups, group g of group_count[g] copies
// from card group_src[g] to card group_dst[g], its copies next in `dsts`,
// `srcs` and `bytes`; sent[g] and done[g] its events (on the source card
// and the target card; unused within one card); streams[k] card k's
// stream.  Returns the first error; the current device is left as it was.
GME_API int gme_run_step(int n_groups, const int* group_src, const int* group_dst,
                         const int* group_count, void* const* sent, void* const* done,
                         void* const* dsts, const void* const* srcs, const size_t* bytes,
                         void* const* streams) {
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  err = run_groups(n_groups, group_src, group_dst, group_count, sent, done, dsts, srcs, bytes,
                   streams);
  cudaError_t back = cudaSetDevice(current);
  return err != cudaSuccess ? err : back;
}
