// K1's product kernel at 4 to 5 limbs (see modmatmul.cu).
#include "modmatmul_product.cuh"

namespace spasm_k1 {

cudaError_t product_hi(int nl, const Product& a) {
    switch (nl) {
        case 4: return launch<4>(a);
        case 5: return launch<5>(a);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace spasm_k1
