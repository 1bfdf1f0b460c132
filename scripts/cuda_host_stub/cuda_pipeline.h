// Host stand-in for <cuda_pipeline.h>: the cp.async primitives are in the
// stub's cuda_runtime.h (synchronous copies).
#pragma once
#include "cuda_runtime.h"
