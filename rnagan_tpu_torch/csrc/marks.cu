// Device stage marks: one empty kernel per stage of a step, so a trace of
// the device names the stage that the work after each mark belongs to.
//
// Replaces no TPU kernel. A captured CUDA graph replays its kernels under
// one cudaGraphLaunch, so no host range can say which stage a replayed
// kernel belongs to; a kernel launched at each stage boundary during the
// capture is replayed with the rest, and its symbol names the stage
// (rnagan_mark_<stage>). core/profiling.py::mark launches them only while a
// graph is being captured or a profiler records.
//
// Cost: one block of one thread that does nothing, about a microsecond of
// device time per mark; no memory is read or written.

#include <cuda_runtime.h>

// The stages, in the order of core/profiling.py's STAGES.
#define RNAGAN_STAGES(X)                                                            \
  X(gan_ingest) X(gan_encode) X(gan_noise) X(gan_g_forward) X(gan_d_forward)        \
  X(gan_gp) X(gan_d_backward) X(gan_d_adam) X(gan_g_step) X(gan_g_adam)             \
  X(gan_stats) X(gan_attn) X(render)                                                \
  X(vae_rows) X(vae_mask) X(vae_forward) X(vae_backward) X(vae_adam) X(vae_stats)   \
  X(synth_encode) X(synth_noise) X(synth_generator) X(synth_quantize) X(end)

#define RNAGAN_MARK_KERNEL(name) \
  __global__ void rnagan_mark_##name() {}
RNAGAN_STAGES(RNAGAN_MARK_KERNEL)

namespace {

#define RNAGAN_MARK_ENUM(name) k_##name,
enum Stage { RNAGAN_STAGES(RNAGAN_MARK_ENUM) kStages };

}  // namespace

// Launches stage `stage`'s mark on `stream`. Returns the cudaError_t.
extern "C" int rnagan_mark(int stage, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
#define RNAGAN_MARK_LAUNCH(name) \
    case k_##name: rnagan_mark_##name<<<1, 1, 0, s>>>(); break;
    RNAGAN_STAGES(RNAGAN_MARK_LAUNCH)
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
