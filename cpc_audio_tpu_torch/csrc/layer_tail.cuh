// K3's width classes, shared by its forward (csrc/layer_tail_fwd.cu) and
// both backward bodies (csrc/layer_tail_bwd.cu, csrc/layer_tail_bwd_tc.cu):
// class W serves D up to 256 << W, and each source indexes a table of its
// per-class instantiations with it.  ops/ffn.py's `_width_class` mirrors
// it for the pure gate.
#pragma once

namespace cpc {

constexpr int kTailMaxD = 1024;    // K2's limit: 8 heads of dk <= 128
constexpr int kTailClasses = 3;

inline int tail_width_class(int D) { return D <= 256 ? 0 : D <= 512 ? 1 : 2; }

}  // namespace cpc
