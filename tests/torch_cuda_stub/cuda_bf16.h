// CPU stand-in for CUDA's header of the same name: see cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
