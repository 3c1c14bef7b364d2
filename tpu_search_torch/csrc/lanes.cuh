// The full-warp lane mask of the shuffles and ballots, one definition for
// the headers that share a translation unit (topk_select.cuh, int8_mma.cuh).
#pragma once

namespace {

constexpr unsigned kFull = 0xffffffffu;

}  // namespace
