// The forward direction's instances of the CFFT pass kernel (see cfft.cu).
#include "cfft_pass.cuh"

namespace tstwo {
namespace cfft {

PassKernel forward_kernel_of(const Pass& p) { return kernel_of<false>(p); }

}  // namespace cfft
}  // namespace tstwo
