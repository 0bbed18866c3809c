// K4 cut after its phase 4 (the closure: J's columns left out) for
// probes/dydt_kernel.py and chip_smoke.py phase 11f: the launcher's own
// kernel template (pyjac_tpu_torch/csrc/dense_fused.cu, included, not
// copied) launched through its own `launch<double, 4>`, on the C entry's
// arguments.  The yardstick of the dy/dt kernel (csrc/dydt.cu), which
// runs the same phases cut down to f.

#include "../pyjac_tpu_torch/csrc/dense_fused.cu"

extern "C" int dyk_k4_cut4(DENSE_FUSED_PARAMS(double)) {
  return launch<double, 4>(DENSE_FUSED_ARGS);
}
