// The path kernel's instances for scenes with spheres or quads (template
// bit K_PRIMS set); the template and its notes are in path_kernel.cuh.
// A translation unit of its own so that nvcc compiles it beside
// path_kernel.cu.

#include "path_kernel.cuh"

namespace dsrt {
namespace path {

static const KernelFn primitive_instances[8] = {
    path_render_kernel<1>,  path_render_kernel<3>,  path_render_kernel<5>,
    path_render_kernel<7>,  path_render_kernel<9>,  path_render_kernel<11>,
    path_render_kernel<13>, path_render_kernel<15>};

int launch_primitives(unsigned m, const PathArgs& a, const float* params, cudaStream_t s) {
  if (!(m & K_PRIMS) || m >= (unsigned)N_INSTANCES) return (int)cudaErrorInvalidValue;
  return launch_instance(primitive_instances[m >> 1], m, a, params, s);
}

KernelFn primitives_kernel(unsigned m) { return primitive_instances[m >> 1]; }

}  // namespace path
}  // namespace dsrt
