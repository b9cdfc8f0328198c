// The PyTorch operators torch.ops.nfs_tpu_torch.* through which the kernel
// wrappers of nfs_tpu_torch/ops launch the CUDA kernels of advect.cu and
// binsplat.cu on CUDA tensors.
//
// The advection operators take one field (D, H, W) or a batch of B fields
// (B, D, H, W), with displacements of the same shape and a trailing 3, and
// launch once either way; so do the binned-splat operators with one set of
// (K, Zp, Yp, Xp) bins or a keyframe batch of them (B, K, Zp, Yp, Xp), and
// the colour operators with one keyframe's slot-minor bins or a batch.
//
// Each operator checks its tensors as the Python wrappers check CPU ones:
// for each tensor in turn, TypeError unless it is float32 (int64 or int32
// for the binned route's sorted indices and offsets, bool for the colour
// bins' valid slots), ValueError unless it
// has its shape, lies on the first tensor's device and is contiguous. It allocates the outputs, reads the device's current stream
// through c10 and calls the kernel's C entry point (which makes the device
// current when it is not); RuntimeError on the CUDA error that entry point
// returns. Built with the host compiler against torch's headers and linked
// to the two kernel libraries (ops/_cuda_build.py): a call from Python then
// costs the dispatcher's argument parsing, not a Python frame per check and
// a ctypes conversion per argument (PERF.md gives both).

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <climits>
#include <initializer_list>
#include <string>
#include <tuple>
#include <vector>

extern "C" {
int nfs_advect_fwd(const void* field, const void* vel, void* out, int B,
                   int D, int H, int W, float max_disp, int device,
                   void* stream);
int nfs_advect_bwd_field(const void* vel, const void* g, void* grad_field,
                         int B, int D, int H, int W, float max_disp, int R,
                         int TZ, int TY, int TX, int smem_bytes, int device,
                         void* stream);
int nfs_advect_bwd_field_untiled(const void* vel, const void* g,
                                 void* grad_field, int B, int D, int H,
                                 int W, float max_disp, int R, int device,
                                 void* stream);
int nfs_advect_bin_sources(const void* vel, const void* g, void* keys,
                           void* rec, int B, int D, int H, int W,
                           float max_disp, int device, void* stream);
int nfs_advect_bwd_field_binned(const void* rec, const void* perm,
                                const void* offsets, void* grad_field,
                                int B, int D, int H, int W, int device,
                                void* stream);
int nfs_advect_bwd_vel(const void* field, const void* vel, const void* g,
                       void* grad_s, int B, int D, int H, int W,
                       float max_disp, int device, void* stream);
int nfs_advect_bwd_fused(const void* field, const void* vel, const void* g,
                         void* grad_field, void* grad_s, int B, int D, int H,
                         int W, float max_disp, int R, int TZ, int TY,
                         int TX, int smem_bytes, int device, void* stream);
int nfs_binsplat_fwd(const void* a, const void* pz, const void* py,
                     const void* px, void* out, int B, int K, int Z, int Y,
                     int X, int device, void* stream);
int nfs_binsplat_bwd(const void* a, const void* pz, const void* py,
                     const void* px, const void* g, void* da, void* dpz,
                     void* dpy, void* dpx, int B, int K, int Z, int Y, int X,
                     int device, void* stream);
int nfs_binsplat_color_fwd(const void* p, const void* dens, const void* color,
                           const void* valid, void* out, int B, int K, int S,
                           int Z, int Y, int X, int device, void* stream);
int nfs_binsplat_color_bwd(const void* p, const void* dens, const void* color,
                           const void* valid, const void* g, void* dp,
                           void* ddens, void* dcolor, int B, int K, int S,
                           int Z, int Y, int X, int device, void* stream);
}

namespace {

using at::Tensor;

// A shape as the Python wrappers print it: "(24, 16, 40)".
std::string shape_str(at::IntArrayRef shape) {
  std::string s = "(";
  for (size_t i = 0; i < shape.size(); ++i) {
    s += (i ? ", " : "") + std::to_string(shape[i]);
  }
  return s + (shape.size() == 1 ? ",)" : ")");
}

void check(const char* name, const Tensor& t, at::IntArrayRef shape,
           const at::Device& device) {
  TORCH_CHECK_TYPE(t.scalar_type() == at::kFloat, name,
                   ": expected float32, got ", t.scalar_type());
  TORCH_CHECK_VALUE(t.sizes().equals(shape), name, ": expected shape ",
                    shape_str(shape), ", got ", shape_str(t.sizes()));
  TORCH_CHECK_VALUE(t.device() == device, name, ": on ", t.device(),
                    ", expected ", device);
  TORCH_CHECK_VALUE(t.is_contiguous(), name, ": must be contiguous");
}

// The grid of a field (D, H, W), or of a batch of B fields (B, D, H, W),
// and the shapes of the field and of a displacement on it ((B,) D, H, W,
// 3). A single field is a batch of one.
struct Grid {
  int B, D, H, W;
  std::vector<int64_t> cells, vec;
};

Grid grid_of(const char* name, at::IntArrayRef sizes) {
  const size_t dim = sizes.size();
  TORCH_CHECK_VALUE(dim == 3 || dim == 4, name,
                    ": expected (D, H, W) or (B, D, H, W), got ",
                    shape_str(sizes));
  std::vector<int64_t> cells(sizes.begin(), sizes.end());
  std::vector<int64_t> vec = cells;
  vec.push_back(3);
  const int64_t B = dim == 4 ? sizes[0] : 1;
  const int64_t D = sizes[dim - 3], H = sizes[dim - 2], W = sizes[dim - 1];
  return {static_cast<int>(B), static_cast<int>(D), static_cast<int>(H),
          static_cast<int>(W), cells, vec};
}

Grid grid_of(const char* name, const Tensor& t) {
  return grid_of(name, t.sizes());
}

void* current_stream(const at::Device& device) {
  return c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)
      ->getStream(device)
      .native_handle();
}

void raise_on(int rc, const char* what) {
  TORCH_CHECK(rc == 0, what, ": CUDA launch failed with error ", rc);
}

Tensor advect_fwd(const Tensor& field, const Tensor& vel, double max_disp) {
  const Grid n = grid_of("field", field);
  const at::Device device = field.device();
  check("field", field, n.cells, device);
  check("vel", vel, n.vec, device);
  Tensor out = at::empty_like(field);
  raise_on(nfs_advect_fwd(field.data_ptr(), vel.data_ptr(), out.data_ptr(),
                          n.B, n.D, n.H, n.W, static_cast<float>(max_disp),
                          device.index(), current_stream(device)),
           "advect_fwd");
  return out;
}

Tensor advect_bwd_field(const Tensor& vel, const Tensor& g, double max_disp,
                        int64_t R, int64_t TZ, int64_t TY, int64_t TX,
                        int64_t smem_bytes) {
  const Grid n = grid_of("g", g);
  const at::Device device = g.device();
  check("g", g, n.cells, device);
  check("vel", vel, n.vec, device);
  Tensor out = at::empty_like(g);
  raise_on(nfs_advect_bwd_field(
               vel.data_ptr(), g.data_ptr(), out.data_ptr(), n.B, n.D, n.H,
               n.W, static_cast<float>(max_disp), static_cast<int>(R),
               static_cast<int>(TZ), static_cast<int>(TY),
               static_cast<int>(TX), static_cast<int>(smem_bytes),
               device.index(), current_stream(device)),
           "advect_bwd_field");
  return out;
}

Tensor advect_bwd_field_untiled(const Tensor& vel, const Tensor& g,
                                double max_disp, int64_t R) {
  const Grid n = grid_of("g", g);
  const at::Device device = g.device();
  check("g", g, n.cells, device);
  check("vel", vel, n.vec, device);
  Tensor out = at::empty_like(g);
  raise_on(nfs_advect_bwd_field_untiled(
               vel.data_ptr(), g.data_ptr(), out.data_ptr(), n.B, n.D, n.H,
               n.W, static_cast<float>(max_disp), static_cast<int>(R),
               device.index(), current_stream(device)),
           "advect_bwd_field_untiled");
  return out;
}

// K2's binned route, step 1: (keys, rec), int32 keys shaped as g and
// float32 records (..., 4).
std::tuple<Tensor, Tensor> advect_bin_sources(const Tensor& vel,
                                              const Tensor& g,
                                              double max_disp) {
  const Grid n = grid_of("g", g);
  const at::Device device = g.device();
  check("g", g, n.cells, device);
  check("vel", vel, n.vec, device);
  std::vector<int64_t> rec_shape = n.cells;
  rec_shape.push_back(4);
  Tensor keys = at::empty(n.cells, g.options().dtype(at::kInt));
  Tensor rec = at::empty(rec_shape, g.options());
  raise_on(nfs_advect_bin_sources(vel.data_ptr(), g.data_ptr(),
                                  keys.data_ptr(), rec.data_ptr(), n.B, n.D,
                                  n.H, n.W, static_cast<float>(max_disp),
                                  device.index(), current_stream(device)),
           "advect_bin_sources");
  return {keys, rec};
}

// A flat index tensor of ``numel`` entries of type ``type``.
void check_index(const char* name, const Tensor& t, at::ScalarType type,
                 const char* type_name, int64_t numel,
                 const at::Device& device) {
  TORCH_CHECK_TYPE(t.scalar_type() == type, name, ": expected ", type_name,
                   ", got ", t.scalar_type());
  const std::vector<int64_t> shape = {numel};
  TORCH_CHECK_VALUE(t.sizes().equals(shape), name, ": expected shape ",
                    shape_str(shape), ", got ", shape_str(t.sizes()));
  TORCH_CHECK_VALUE(t.device() == device, name, ": on ", t.device(),
                    ", expected ", device);
  TORCH_CHECK_VALUE(t.is_contiguous(), name, ": must be contiguous");
}

// K2's binned route, step 3: the gradient, shaped as rec less its last
// axis, from step 1's records, the sorted source indices ``perm`` (int64)
// and the runs' ``offsets`` (int32, one more than the cells).
Tensor advect_bwd_field_binned(const Tensor& rec, const Tensor& perm,
                               const Tensor& offsets) {
  TORCH_CHECK_VALUE((rec.dim() == 4 || rec.dim() == 5) && rec.size(-1) == 4,
                    "rec: expected (D, H, W, 4) or (B, D, H, W, 4), got ",
                    shape_str(rec.sizes()));
  const Grid n = grid_of("rec", rec.sizes().slice(0, rec.dim() - 1));
  const at::Device device = rec.device();
  check("rec", rec, rec.sizes(), device);
  const int64_t cells = rec.numel() / 4;
  check_index("perm", perm, at::kLong, "int64", cells, device);
  check_index("offsets", offsets, at::kInt, "int32", cells + 1, device);
  Tensor out = at::empty(n.cells, rec.options());
  raise_on(nfs_advect_bwd_field_binned(rec.data_ptr(), perm.data_ptr(),
                                       offsets.data_ptr(), out.data_ptr(),
                                       n.B, n.D, n.H, n.W, device.index(),
                                       current_stream(device)),
           "advect_bwd_field_binned");
  return out;
}

Tensor advect_bwd_vel(const Tensor& field, const Tensor& vel, const Tensor& g,
                      double max_disp) {
  const Grid n = grid_of("field", field);
  const at::Device device = field.device();
  check("field", field, n.cells, device);
  check("vel", vel, n.vec, device);
  check("g", g, n.cells, device);
  Tensor out = at::empty_like(vel);
  raise_on(nfs_advect_bwd_vel(field.data_ptr(), vel.data_ptr(), g.data_ptr(),
                              out.data_ptr(), n.B, n.D, n.H, n.W,
                              static_cast<float>(max_disp), device.index(),
                              current_stream(device)),
           "advect_bwd_vel");
  return out;
}

std::tuple<Tensor, Tensor> advect_bwd_fused(const Tensor& field,
                                            const Tensor& vel,
                                            const Tensor& g, double max_disp,
                                            int64_t R, int64_t TZ,
                                            int64_t TY, int64_t TX,
                                            int64_t smem_bytes) {
  const Grid n = grid_of("field", field);
  const at::Device device = field.device();
  check("field", field, n.cells, device);
  check("vel", vel, n.vec, device);
  check("g", g, n.cells, device);
  Tensor grad_field = at::empty_like(field);
  Tensor grad_s = at::empty_like(vel);
  raise_on(nfs_advect_bwd_fused(
               field.data_ptr(), vel.data_ptr(), g.data_ptr(),
               grad_field.data_ptr(), grad_s.data_ptr(), n.B, n.D, n.H, n.W,
               static_cast<float>(max_disp), static_cast<int>(R),
               static_cast<int>(TZ), static_cast<int>(TY),
               static_cast<int>(TX), static_cast<int>(smem_bytes),
               device.index(), current_stream(device)),
           "advect_bwd_fused");
  return {grad_field, grad_s};
}

// The bin arrays' checks: a has four axes (K, Zp, Yp, Xp), the positions
// its shape.
void check_bins(const Tensor& a, const Tensor& pz, const Tensor& py,
                const Tensor& px) {
  TORCH_CHECK_VALUE(a.dim() == 4, "a: expected (K, Zp, Yp, Xp), got ",
                    shape_str(a.sizes()));
  const at::Device device = a.device();
  check("a", a, a.sizes(), device);
  check("p_z", pz, a.sizes(), device);
  check("p_y", py, a.sizes(), device);
  check("p_x", px, a.sizes(), device);
}

// The bins of one keyframe (K, Zp, Yp, Xp), checked by check_bins, or of a
// keyframe batch (B, K, Zp, Yp, Xp), checked alike; B (1 for one
// keyframe), the bins' shape less B, and the splat's shape: (Zp, Yp, Xp)
// or (B, Zp, Yp, Xp).
struct Bins {
  int B;
  std::vector<int64_t> bins, cells;
};

Bins bins_of(const Tensor& a, const Tensor& pz, const Tensor& py,
             const Tensor& px) {
  if (a.dim() != 5) {
    check_bins(a, pz, py, px);
    return {1, a.sizes().vec(), a.sizes().slice(1).vec()};
  }
  const at::Device device = a.device();
  check("a", a, a.sizes(), device);
  check("p_z", pz, a.sizes(), device);
  check("p_y", py, a.sizes(), device);
  check("p_x", px, a.sizes(), device);
  std::vector<int64_t> cells = a.sizes().slice(2).vec();
  cells.insert(cells.begin(), a.size(0));
  return {static_cast<int>(a.size(0)), a.sizes().slice(1).vec(), cells};
}

Tensor binsplat_fwd(const Tensor& a, const Tensor& pz, const Tensor& py,
                    const Tensor& px) {
  const Bins n = bins_of(a, pz, py, px);
  Tensor out = at::empty(n.cells, a.options());
  raise_on(nfs_binsplat_fwd(a.data_ptr(), pz.data_ptr(), py.data_ptr(),
                            px.data_ptr(), out.data_ptr(), n.B,
                            static_cast<int>(n.bins[0]),
                            static_cast<int>(n.bins[1]),
                            static_cast<int>(n.bins[2]),
                            static_cast<int>(n.bins[3]), a.device().index(),
                            current_stream(a.device())),
           "binsplat_fwd");
  return out;
}

std::tuple<Tensor, Tensor, Tensor, Tensor> binsplat_bwd(
    const Tensor& a, const Tensor& pz, const Tensor& py, const Tensor& px,
    const Tensor& g) {
  const Bins n = bins_of(a, pz, py, px);
  check("g", g, n.cells, a.device());
  Tensor da = at::empty_like(a), dpz = at::empty_like(a),
         dpy = at::empty_like(a), dpx = at::empty_like(a);
  raise_on(nfs_binsplat_bwd(a.data_ptr(), pz.data_ptr(), py.data_ptr(),
                            px.data_ptr(), g.data_ptr(), da.data_ptr(),
                            dpz.data_ptr(), dpy.data_ptr(), dpx.data_ptr(),
                            n.B, static_cast<int>(n.bins[0]),
                            static_cast<int>(n.bins[1]),
                            static_cast<int>(n.bins[2]),
                            static_cast<int>(n.bins[3]), a.device().index(),
                            current_stream(a.device())),
           "binsplat_bwd");
  return {da, dpz, dpy, dpx};
}

// ``lead`` followed by ``rest``: a shape with the keyframe batch's B, or
// without it.
std::vector<int64_t> with_lead(const std::vector<int64_t>& lead,
                               std::initializer_list<int64_t> rest) {
  std::vector<int64_t> shape = lead;
  shape.insert(shape.end(), rest);
  return shape;
}

// LNST's colour bins of one keyframe, slot-minor as the styler holds
// them: positions p (3, S), densities dens (S,) and colours color (3, S),
// float32, and the dense slots' valid (n_slots,) bool, n_slots = K * (Z +
// 4) * (Y + 4) * (X + 4) <= S for the unpadded grid (Z, Y, X); or a
// keyframe batch with a leading B on all four. Checks them (valid: a
// TypeError unless bool) and returns B (1 for one keyframe), S and the
// leading shape.
struct ColorBins {
  int B, S;
  std::vector<int64_t> lead;
};

ColorBins color_bins_of(const Tensor& p, const Tensor& dens,
                        const Tensor& color, const Tensor& valid, int64_t K,
                        int64_t Z, int64_t Y, int64_t X) {
  TORCH_CHECK_VALUE(p.dim() == 2 || p.dim() == 3,
                    "p: expected ([B,] 3, S), got ", shape_str(p.sizes()));
  const std::vector<int64_t> lead(p.sizes().begin(), p.sizes().end() - 2);
  const int64_t S = p.size(-1);
  const at::Device device = p.device();
  check("p", p, with_lead(lead, {3, S}), device);
  check("dens", dens, with_lead(lead, {S}), device);
  check("color", color, with_lead(lead, {3, S}), device);
  const int64_t n_slots = K * (Z + 4) * (Y + 4) * (X + 4);
  const std::vector<int64_t> mask = with_lead(lead, {n_slots});
  TORCH_CHECK_TYPE(valid.scalar_type() == at::kBool,
                   "valid: expected bool, got ", valid.scalar_type());
  TORCH_CHECK_VALUE(valid.sizes().equals(mask), "valid: expected shape ",
                    shape_str(mask), ", got ", shape_str(valid.sizes()));
  TORCH_CHECK_VALUE(valid.device() == device, "valid: on ", valid.device(),
                    ", expected ", device);
  TORCH_CHECK_VALUE(valid.is_contiguous(), "valid: must be contiguous");
  // numbers formatted by hand, as shape_str does
  TORCH_CHECK_VALUE(n_slots <= S, "valid: " + std::to_string(n_slots) +
                                      " dense slots, more than p's " +
                                      std::to_string(S));
  // the entry points take ints and refuse what their 32-bit indices
  // cannot reach
  const int64_t B = lead.empty() ? 1 : lead[0];
  TORCH_CHECK(B <= INT_MAX && S <= INT_MAX && K <= INT_MAX && Z <= INT_MAX &&
                  Y <= INT_MAX && X <= INT_MAX,
              "colour bins past 32-bit indices");
  return {static_cast<int>(B), static_cast<int>(S), lead};
}

// K4c: the colour splat ([B,] Z, Y, X, 5) of the unpadded grid (Z, Y, X):
// density, colour clipped to [0, 1] and ones.
Tensor binsplat_color_fwd(const Tensor& p, const Tensor& dens,
                          const Tensor& color, const Tensor& valid, int64_t K,
                          int64_t Z, int64_t Y, int64_t X) {
  const ColorBins n = color_bins_of(p, dens, color, valid, K, Z, Y, X);
  Tensor out = at::empty(with_lead(n.lead, {Z, Y, X, 5}), p.options());
  raise_on(nfs_binsplat_color_fwd(
               p.data_ptr(), dens.data_ptr(), color.data_ptr(),
               valid.data_ptr(), out.data_ptr(), n.B, static_cast<int>(K),
               n.S, static_cast<int>(Z), static_cast<int>(Y),
               static_cast<int>(X), p.device().index(),
               current_stream(p.device())),
           "binsplat_color_fwd");
  return out;
}

// K5c: (dp, ddens, dcolor), shaped as p, dens and color, given the colour
// splat's cotangent g ([B,] Z, Y, X, 5), whose shape gives the grid.
std::tuple<Tensor, Tensor, Tensor> binsplat_color_bwd(
    const Tensor& p, const Tensor& dens, const Tensor& color,
    const Tensor& valid, const Tensor& g, int64_t K) {
  TORCH_CHECK_VALUE(p.dim() == 2 || p.dim() == 3,
                    "p: expected ([B,] 3, S), got ", shape_str(p.sizes()));
  TORCH_CHECK_VALUE(g.dim() == p.dim() + 2 && g.size(-1) == 5,
                    "g: expected ([B,] Z, Y, X, 5), got ",
                    shape_str(g.sizes()));
  const int64_t Z = g.size(-4), Y = g.size(-3), X = g.size(-2);
  const ColorBins n = color_bins_of(p, dens, color, valid, K, Z, Y, X);
  check("g", g, with_lead(n.lead, {Z, Y, X, 5}), p.device());
  Tensor dp = at::empty_like(p), ddens = at::empty_like(dens),
         dcolor = at::empty_like(color);
  raise_on(nfs_binsplat_color_bwd(
               p.data_ptr(), dens.data_ptr(), color.data_ptr(),
               valid.data_ptr(), g.data_ptr(), dp.data_ptr(),
               ddens.data_ptr(), dcolor.data_ptr(), n.B, static_cast<int>(K),
               n.S, static_cast<int>(Z), static_cast<int>(Y),
               static_cast<int>(X), p.device().index(),
               current_stream(p.device())),
           "binsplat_color_bwd");
  return {dp, ddens, dcolor};
}

}  // namespace

TORCH_LIBRARY(nfs_tpu_torch, m) {
  m.def("advect_fwd(Tensor field, Tensor vel, float max_disp) -> Tensor");
  m.def(
      "advect_bwd_field(Tensor vel, Tensor g, float max_disp, int R, int TZ, "
      "int TY, int TX, int smem_bytes) -> Tensor");
  m.def(
      "advect_bwd_field_untiled(Tensor vel, Tensor g, float max_disp, int R) "
      "-> Tensor");
  m.def(
      "advect_bin_sources(Tensor vel, Tensor g, float max_disp) -> (Tensor, "
      "Tensor)");
  m.def(
      "advect_bwd_field_binned(Tensor rec, Tensor perm, Tensor offsets) -> "
      "Tensor");
  m.def(
      "advect_bwd_vel(Tensor field, Tensor vel, Tensor g, float max_disp) "
      "-> Tensor");
  m.def(
      "advect_bwd_fused(Tensor field, Tensor vel, Tensor g, float max_disp, "
      "int R, int TZ, int TY, int TX, int smem_bytes) -> (Tensor, Tensor)");
  m.def("binsplat_fwd(Tensor a, Tensor pz, Tensor py, Tensor px) -> Tensor");
  m.def(
      "binsplat_bwd(Tensor a, Tensor pz, Tensor py, Tensor px, Tensor g) -> "
      "(Tensor, Tensor, Tensor, Tensor)");
  m.def(
      "binsplat_color_fwd(Tensor p, Tensor dens, Tensor color, Tensor valid, "
      "int K, int Z, int Y, int X) -> Tensor");
  m.def(
      "binsplat_color_bwd(Tensor p, Tensor dens, Tensor color, Tensor valid, "
      "Tensor g, int K) -> (Tensor, Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(nfs_tpu_torch, CUDA, m) {
  m.impl("advect_fwd", &advect_fwd);
  m.impl("advect_bwd_field", &advect_bwd_field);
  m.impl("advect_bwd_field_untiled", &advect_bwd_field_untiled);
  m.impl("advect_bin_sources", &advect_bin_sources);
  m.impl("advect_bwd_field_binned", &advect_bwd_field_binned);
  m.impl("advect_bwd_vel", &advect_bwd_vel);
  m.impl("advect_bwd_fused", &advect_bwd_fused);
  m.impl("binsplat_fwd", &binsplat_fwd);
  m.impl("binsplat_bwd", &binsplat_bwd);
  m.impl("binsplat_color_fwd", &binsplat_color_fwd);
  m.impl("binsplat_color_bwd", &binsplat_color_bwd);
}
