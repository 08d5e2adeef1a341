// LAPACK's zgesv_ for the native BEM core (native/bem/bem.cpp), which calls
// that one routine for its influence solves.  The definition forwards to a
// zgesv handed in once at load time through raft_bem_set_zgesv: the port
// passes the one of the LAPACK that scipy ships
// (scipy.linalg.cython_lapack), so the library links no system LAPACK.
// Until the setter has run, every call reports info = -999, which the core
// turns into its error return.
#include <complex>

using cplx = std::complex<double>;
using zgesv_fn = void (*)(const int*, const int*, cplx*, const int*, int*,
                          cplx*, const int*, int*);

static zgesv_fn g_zgesv = nullptr;

extern "C" {

void raft_bem_set_zgesv(void* fn) {
    g_zgesv = reinterpret_cast<zgesv_fn>(fn);
}

void zgesv_(const int* n, const int* nrhs, cplx* a, const int* lda,
            int* ipiv, cplx* b, const int* ldb, int* info) {
    if (g_zgesv == nullptr) {
        *info = -999;
        return;
    }
    g_zgesv(n, nrhs, a, lda, ipiv, b, ldb, info);
}

}  // extern "C"
