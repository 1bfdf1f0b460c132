// Host stand-in for cooperative_groups' grid group (see cuda_runtime.h):
// grid sync is a std::barrier over every thread of a stub_launch_coop grid.
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { stub_grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
