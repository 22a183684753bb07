// Shared C entry points of the port's kernel library.
#include <cuda_runtime.h>

extern "C" const char* gsplat_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
