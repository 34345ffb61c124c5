// K1's product kernel at 1 to 3 limbs (see modmatmul.cu).
#include "modmatmul_product.cuh"

namespace spasm_k1 {

cudaError_t product_lo(int nl, const Product& a) {
    switch (nl) {
        case 1: return launch<1>(a);
        case 2: return launch<2>(a);
        case 3: return launch<3>(a);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace spasm_k1
