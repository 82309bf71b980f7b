// Native BVH builder for dsrt_tpu_torch (a copy of the JAX package's
// dsrt_tpu/native/bvh_builder.cpp).
//
// Host-side scene-compile kernel mirroring the NumPy builders in
// models/bvh_build.py (which themselves reproduce the semantics of the
// reference's CPU builder, src/gpu_scene_builder.cpp:343-459): median split
// on the largest-extent centroid axis via nth_element, leaf <= 4
// triangles, degenerate-centroid leaves, preorder node emission with
// left-child == parent+1; plus a binned-SAH mode with a median fallback
// and a depth cap that keeps traversal stacks within 64 entries.
//
// Flat-extent boxes are padded (FLAT_EPS) exactly like the Python builder —
// the deliberate fix for the reference's invisible axis-aligned triangles.
//
// C ABI (ctypes-friendly); exact-match contract with the Python "median"
// builder is covered by tests/test_bvh.py; the port's tables are held
// bit-identical to the JAX package's by tests/test_torch_scene.py.
//
// Built by dsrt_tpu_torch/native.py with g++ at first use into
// build/dsrt_tpu_torch/ (the JAX package's Makefile flags with -mfma in
// place of -march=native: GCC contracts a*b+c into FMAs as it did for the
// JAX package's library, so the trees are bit-identical).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kMaxLeaf = 4;
constexpr int kSahBins = 16;
constexpr int kSahDepthCap = 48;  // force median below this depth
constexpr float kFlatEps = 1e-4f;

struct F3 {
  float x, y, z;
};

struct Builder {
  const float* v0;
  const float* v1;
  const float* v2;
  int n;
  std::vector<F3> lo, hi, cent;
  std::vector<int32_t> indices;

  // node arrays (output)
  std::vector<F3> bmin, bmax;
  std::vector<int32_t> left, right, offset, count;

  void prepare() {
    lo.resize(n);
    hi.resize(n);
    cent.resize(n);
    indices.resize(n);
    for (int i = 0; i < n; ++i) {
      const float* a = v0 + 3 * i;
      const float* b = v1 + 3 * i;
      const float* c = v2 + 3 * i;
      lo[i] = {std::min(a[0], std::min(b[0], c[0])),
               std::min(a[1], std::min(b[1], c[1])),
               std::min(a[2], std::min(b[2], c[2]))};
      hi[i] = {std::max(a[0], std::max(b[0], c[0])),
               std::max(a[1], std::max(b[1], c[1])),
               std::max(a[2], std::max(b[2], c[2]))};
      cent[i] = {(a[0] + b[0] + c[0]) / 3.f, (a[1] + b[1] + c[1]) / 3.f,
                 (a[2] + b[2] + c[2]) / 3.f};
      indices[i] = i;
    }
  }

  int emit_node(int start, int end) {
    F3 mn = lo[indices[start]];
    F3 mx = hi[indices[start]];
    for (int i = start + 1; i < end; ++i) {
      const F3& a = lo[indices[i]];
      const F3& b = hi[indices[i]];
      mn = {std::min(mn.x, a.x), std::min(mn.y, a.y), std::min(mn.z, a.z)};
      mx = {std::max(mx.x, b.x), std::max(mx.y, b.y), std::max(mx.z, b.z)};
    }
    // flat-extent padding (models/bvh_build.py _pad_flat)
    if (mx.x - mn.x < kFlatEps) { mn.x -= kFlatEps * 0.5f; mx.x += kFlatEps * 0.5f; }
    if (mx.y - mn.y < kFlatEps) { mn.y -= kFlatEps * 0.5f; mx.y += kFlatEps * 0.5f; }
    if (mx.z - mn.z < kFlatEps) { mn.z -= kFlatEps * 0.5f; mx.z += kFlatEps * 0.5f; }
    int node = (int)bmin.size();
    bmin.push_back(mn);
    bmax.push_back(mx);
    left.push_back(-1);
    right.push_back(-1);
    offset.push_back(start);
    count.push_back(end - start);
    return node;
  }

  void centroid_bounds(int start, int end, F3& cmn, F3& cmx) const {
    cmn = cmx = cent[indices[start]];
    for (int i = start + 1; i < end; ++i) {
      const F3& c = cent[indices[i]];
      cmn = {std::min(cmn.x, c.x), std::min(cmn.y, c.y), std::min(cmn.z, c.z)};
      cmx = {std::max(cmx.x, c.x), std::max(cmx.y, c.y), std::max(cmx.z, c.z)};
    }
  }

  float axis_of(const F3& c, int axis) const {
    return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
  }

  int build_median(int start, int end) {
    int node = emit_node(start, end);
    int cnt = end - start;
    if (cnt <= kMaxLeaf) return node;

    F3 cmn, cmx;
    centroid_bounds(start, end, cmn, cmx);
    float dx = cmx.x - cmn.x, dy = cmx.y - cmn.y, dz = cmx.z - cmn.z;
    // reference tie-breaking (builder.cpp:404-406)
    int axis = 0;
    if (dy > dx && dy >= dz) axis = 1;
    else if (dz > dx && dz >= dy) axis = 2;
    float ext = axis == 0 ? dx : (axis == 1 ? dy : dz);
    if (ext == 0.0f) return node;  // degenerate -> leaf

    int mid = (start + end) / 2;
    std::nth_element(indices.begin() + start, indices.begin() + mid,
                     indices.begin() + end, [&](int a, int b) {
                       return axis_of(cent[a], axis) < axis_of(cent[b], axis);
                     });
    offset[node] = 0;
    count[node] = 0;
    int l = build_median(start, mid);
    int r = build_median(mid, end);
    left[node] = l;
    right[node] = r;
    return node;
  }

  static float surface(const F3& mn, const F3& mx) {
    float dx = std::max(mx.x - mn.x, 0.f);
    float dy = std::max(mx.y - mn.y, 0.f);
    float dz = std::max(mx.z - mn.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }

  int build_sah(int start, int end, int depth) {
    int node = emit_node(start, end);
    int cnt = end - start;
    if (cnt <= kMaxLeaf) return node;

    F3 cmn, cmx;
    centroid_bounds(start, end, cmn, cmx);
    float d[3] = {cmx.x - cmn.x, cmx.y - cmn.y, cmx.z - cmn.z};
    int axis = 0;
    if (d[1] > d[axis]) axis = 1;
    if (d[2] > d[axis]) axis = 2;
    if (d[axis] <= 0.f) return node;

    int mid = -1;
    if (depth < kSahDepthCap) {
      float cmin = axis_of(cmn, axis);
      float inv = (float)kSahBins / d[axis];
      F3 bin_lo[kSahBins], bin_hi[kSahBins];
      int64_t bin_n[kSahBins] = {0};
      for (int b = 0; b < kSahBins; ++b) {
        bin_lo[b] = {1e30f, 1e30f, 1e30f};
        bin_hi[b] = {-1e30f, -1e30f, -1e30f};
      }
      auto bin_of = [&](int tri) {
        int b = (int)((axis_of(cent[tri], axis) - cmin) * inv);
        return std::min(b, kSahBins - 1);
      };
      for (int i = start; i < end; ++i) {
        int t = indices[i];
        int b = bin_of(t);
        const F3& a = lo[t];
        const F3& h = hi[t];
        bin_lo[b] = {std::min(bin_lo[b].x, a.x), std::min(bin_lo[b].y, a.y),
                     std::min(bin_lo[b].z, a.z)};
        bin_hi[b] = {std::max(bin_hi[b].x, h.x), std::max(bin_hi[b].y, h.y),
                     std::max(bin_hi[b].z, h.z)};
        bin_n[b]++;
      }
      F3 suf_lo[kSahBins], suf_hi[kSahBins];
      int64_t suf_n[kSahBins];
      F3 run_lo = bin_lo[kSahBins - 1], run_hi = bin_hi[kSahBins - 1];
      int64_t run_n = bin_n[kSahBins - 1];
      for (int b = kSahBins - 1; b >= 0; --b) {
        if (b < kSahBins - 1) {
          run_lo = {std::min(run_lo.x, bin_lo[b].x), std::min(run_lo.y, bin_lo[b].y),
                    std::min(run_lo.z, bin_lo[b].z)};
          run_hi = {std::max(run_hi.x, bin_hi[b].x), std::max(run_hi.y, bin_hi[b].y),
                    std::max(run_hi.z, bin_hi[b].z)};
          run_n += bin_n[b];
        }
        suf_lo[b] = run_lo;
        suf_hi[b] = run_hi;
        suf_n[b] = run_n;
      }
      float best_cost = 1e38f;
      int best_split = -1;
      F3 pre_lo = bin_lo[0], pre_hi = bin_hi[0];
      int64_t pre_n = bin_n[0];
      for (int s = 0; s < kSahBins - 1; ++s) {
        if (s > 0) {
          pre_lo = {std::min(pre_lo.x, bin_lo[s].x), std::min(pre_lo.y, bin_lo[s].y),
                    std::min(pre_lo.z, bin_lo[s].z)};
          pre_hi = {std::max(pre_hi.x, bin_hi[s].x), std::max(pre_hi.y, bin_hi[s].y),
                    std::max(pre_hi.z, bin_hi[s].z)};
          pre_n += bin_n[s];
        }
        if (pre_n == 0 || suf_n[s + 1] == 0) continue;
        float cost = surface(pre_lo, pre_hi) * pre_n
                     + surface(suf_lo[s + 1], suf_hi[s + 1]) * suf_n[s + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_split = s;
        }
      }
      float leaf_cost = surface(bmin[node], bmax[node]) * cnt;
      if (best_split >= 0
          && !(cnt <= 2 * kMaxLeaf && best_cost >= leaf_cost)) {
        auto it = std::partition(indices.begin() + start, indices.begin() + end,
                                 [&](int t) { return bin_of(t) <= best_split; });
        mid = (int)(it - indices.begin());
        if (mid == start || mid == end) mid = -1;  // safety: force median
      }
    }
    if (mid < 0) {
      mid = (start + end) / 2;
      std::nth_element(indices.begin() + start, indices.begin() + mid,
                       indices.begin() + end, [&](int a, int b) {
                         return axis_of(cent[a], axis) < axis_of(cent[b], axis);
                       });
    }
    offset[node] = 0;
    count[node] = 0;
    int l = build_sah(start, mid, depth + 1);
    int r = build_sah(mid, end, depth + 1);
    left[node] = l;
    right[node] = r;
    return node;
  }
};

// ---------------------------------------------------------------------
// SBVH: binned object SAH over all 3 axes + binned spatial splits
// (Stich/Friedrich/Dammertz 2009), mirroring models/bvh_build.py
// _build_sbvh.  Straddling triangles are REFERENCED on both sides with
// clipped bounds, so the output tri_indices is a reference list
// (n_refs >= n) — closest-hit results are exactly unchanged.

struct SBuilder {
  const float* v0;
  const float* v1;
  const float* v2;
  int n;
  float alpha;
  size_t max_refs;

  std::vector<int32_t> ref_tri;
  std::vector<F3> rlo, rhi;

  std::vector<F3> bmin, bmax;
  std::vector<int32_t> left, right, offset, count;
  std::vector<int32_t> out_refs;  // leaf-order emission
  float root_sa = -1.f;

  static F3 fmin3(const F3& a, const F3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
  }
  static F3 fmax3(const F3& a, const F3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
  }
  static float axis_of(const F3& c, int axis) {
    return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
  }
  static float surface(const F3& mn, const F3& mx) {
    float dx = std::max(mx.x - mn.x, 0.f);
    float dy = std::max(mx.y - mn.y, 0.f);
    float dz = std::max(mx.z - mn.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }

  void prepare() {
    ref_tri.resize(n);
    rlo.resize(n);
    rhi.resize(n);
    for (int i = 0; i < n; ++i) {
      const float* a = v0 + 3 * i;
      const float* b = v1 + 3 * i;
      const float* c = v2 + 3 * i;
      rlo[i] = {std::min(a[0], std::min(b[0], c[0])),
                std::min(a[1], std::min(b[1], c[1])),
                std::min(a[2], std::min(b[2], c[2]))};
      rhi[i] = {std::max(a[0], std::max(b[0], c[0])),
                std::max(a[1], std::max(b[1], c[1])),
                std::max(a[2], std::max(b[2], c[2]))};
      ref_tri[i] = i;
    }
  }

  // AABB of triangle `tri` clipped to slab [x0, x1] on `axis` (vertices
  // inside + edge/plane intersections; the chopped-binning trick).
  // Returns false if the clipped polygon is empty.
  bool clip_tri(int tri, int axis, float x0, float x1, F3& omn,
                F3& omx) const {
    const float* P[3] = {v0 + 3 * tri, v1 + 3 * tri, v2 + 3 * tri};
    F3 mn = {1e30f, 1e30f, 1e30f};
    F3 mx = {-1e30f, -1e30f, -1e30f};
    bool any = false;
    for (int k = 0; k < 3; ++k) {
      float xa = P[k][axis];
      if (xa >= x0 && xa <= x1) {
        F3 p = {P[k][0], P[k][1], P[k][2]};
        mn = fmin3(mn, p);
        mx = fmax3(mx, p);
        any = true;
      }
      const float* A = P[k];
      const float* B = P[(k + 1) % 3];
      float da = A[axis], db = B[axis];
      for (float xp : {x0, x1}) {
        if (!(xp > -1e29f && xp < 1e29f)) continue;  // half-open slab
        if ((da - xp) * (db - xp) < 0.f) {
          float t = (xp - da) / (db - da);
          F3 q = {A[0] + t * (B[0] - A[0]), A[1] + t * (B[1] - A[1]),
                  A[2] + t * (B[2] - A[2])};
          (axis == 0 ? q.x : axis == 1 ? q.y : q.z) = xp;
          mn = fmin3(mn, q);
          mx = fmax3(mx, q);
          any = true;
        }
      }
    }
    omn = mn;
    omx = mx;
    return any;
  }

  int emit(const std::vector<int32_t>& ids) {
    F3 mn = rlo[ids[0]], mx = rhi[ids[0]];
    for (size_t i = 1; i < ids.size(); ++i) {
      mn = fmin3(mn, rlo[ids[i]]);
      mx = fmax3(mx, rhi[ids[i]]);
    }
    if (root_sa < 0.f) root_sa = std::max(surface(mn, mx), 1e-30f);
    if (mx.x - mn.x < kFlatEps) { mn.x -= kFlatEps * .5f; mx.x += kFlatEps * .5f; }
    if (mx.y - mn.y < kFlatEps) { mn.y -= kFlatEps * .5f; mx.y += kFlatEps * .5f; }
    if (mx.z - mn.z < kFlatEps) { mn.z -= kFlatEps * .5f; mx.z += kFlatEps * .5f; }
    int node = (int)bmin.size();
    bmin.push_back(mn);
    bmax.push_back(mx);
    left.push_back(-1);
    right.push_back(-1);
    offset.push_back(-1);
    count.push_back((int)ids.size());
    return node;
  }

  void make_leaf(int node, const std::vector<int32_t>& ids) {
    offset[node] = (int)out_refs.size();
    count[node] = (int)ids.size();
    for (int32_t id : ids) out_refs.push_back(ref_tri[id]);
  }

  int recurse(std::vector<int32_t> ids, int depth) {
    int node = emit(ids);
    size_t cnt = ids.size();
    if (cnt <= (size_t)kMaxLeaf || depth > 62) {
      make_leaf(node, ids);
      return node;
    }
    // unpadded node bounds (bins/planes use the true extents)
    F3 nb_min = rlo[ids[0]], nb_max = rhi[ids[0]];
    for (size_t i = 1; i < cnt; ++i) {
      nb_min = fmin3(nb_min, rlo[ids[i]]);
      nb_max = fmax3(nb_max, rhi[ids[i]]);
    }

    // ---- best binned OBJECT split over all 3 axes --------------------
    float best_cost = 1e38f;
    int best_axis = -1, best_split = -1;
    F3 best_ov_lo = {}, best_ov_hi = {};
    F3 cmn = {1e30f, 1e30f, 1e30f}, cmx = {-1e30f, -1e30f, -1e30f};
    std::vector<F3> cent(cnt);
    for (size_t i = 0; i < cnt; ++i) {
      cent[i] = {(rlo[ids[i]].x + rhi[ids[i]].x) * .5f,
                 (rlo[ids[i]].y + rhi[ids[i]].y) * .5f,
                 (rlo[ids[i]].z + rhi[ids[i]].z) * .5f};
      cmn = fmin3(cmn, cent[i]);
      cmx = fmax3(cmx, cent[i]);
    }
    float cmin_a[3] = {cmn.x, cmn.y, cmn.z};
    float cext[3] = {cmx.x - cmn.x, cmx.y - cmn.y, cmx.z - cmn.z};
    for (int axis = 0; axis < 3; ++axis) {
      if (cext[axis] <= 0.f) continue;
      float inv = (float)kSahBins / cext[axis];
      F3 bl[kSahBins], bh[kSahBins];
      int64_t bn[kSahBins] = {0};
      for (int b = 0; b < kSahBins; ++b) {
        bl[b] = {1e30f, 1e30f, 1e30f};
        bh[b] = {-1e30f, -1e30f, -1e30f};
      }
      for (size_t i = 0; i < cnt; ++i) {
        int b = std::min((int)((axis_of(cent[i], axis) - cmin_a[axis]) * inv),
                         kSahBins - 1);
        bl[b] = fmin3(bl[b], rlo[ids[i]]);
        bh[b] = fmax3(bh[b], rhi[ids[i]]);
        bn[b]++;
      }
      F3 suf_lo[kSahBins], suf_hi[kSahBins];
      int64_t suf_n[kSahBins];
      F3 rl = bl[kSahBins - 1], rh = bh[kSahBins - 1];
      int64_t rn = bn[kSahBins - 1];
      for (int b = kSahBins - 1; b >= 0; --b) {
        if (b < kSahBins - 1) {
          rl = fmin3(rl, bl[b]);
          rh = fmax3(rh, bh[b]);
          rn += bn[b];
        }
        suf_lo[b] = rl;
        suf_hi[b] = rh;
        suf_n[b] = rn;
      }
      F3 pl = bl[0], ph = bh[0];
      int64_t pn = bn[0];
      for (int s = 0; s < kSahBins - 1; ++s) {
        if (s > 0) {
          pl = fmin3(pl, bl[s]);
          ph = fmax3(ph, bh[s]);
          pn += bn[s];
        }
        if (pn == 0 || suf_n[s + 1] == 0) continue;
        float cost = surface(pl, ph) * pn
                     + surface(suf_lo[s + 1], suf_hi[s + 1]) * suf_n[s + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_split = s;
          best_ov_lo = fmax3(pl, suf_lo[s + 1]);
          best_ov_hi = fmin3(ph, suf_hi[s + 1]);
        }
      }
    }

    // ---- binned SPATIAL split when object children overlap -----------
    int sp_axis = -1;
    float sp_plane = 0.f, sp_cost = 1e38f;
    if (best_axis >= 0 && ref_tri.size() < max_refs) {
      float ov_sa = surface(best_ov_lo, best_ov_hi);
      bool valid_ov = best_ov_hi.x >= best_ov_lo.x
                      && best_ov_hi.y >= best_ov_lo.y
                      && best_ov_hi.z >= best_ov_lo.z;
      if (valid_ov && ov_sa / root_sa > alpha) {
        float nbm[3] = {nb_min.x, nb_min.y, nb_min.z};
        float nbx[3] = {nb_max.x, nb_max.y, nb_max.z};
        for (int axis = 0; axis < 3; ++axis) {
          float ext = nbx[axis] - nbm[axis];
          if (ext <= 0.f) continue;
          float w = ext / kSahBins;
          F3 bl[kSahBins], bh[kSahBins];
          int64_t entry[kSahBins] = {0}, exit_[kSahBins] = {0};
          for (int b = 0; b < kSahBins; ++b) {
            bl[b] = {1e30f, 1e30f, 1e30f};
            bh[b] = {-1e30f, -1e30f, -1e30f};
          }
          for (size_t i = 0; i < cnt; ++i) {
            int id = ids[i];
            int b0 = std::min(std::max((int)((axis_of(rlo[id], axis) - nbm[axis]) / w), 0), kSahBins - 1);
            int b1 = std::min(std::max((int)((axis_of(rhi[id], axis) - nbm[axis]) / w), 0), kSahBins - 1);
            entry[b0]++;
            exit_[b1]++;
            for (int b = b0; b <= b1; ++b) {
              F3 cmn2, cmx2;
              if (!clip_tri(ref_tri[id], axis, nbm[axis] + b * w,
                            nbm[axis] + (b + 1) * w, cmn2, cmx2))
                continue;
              cmn2 = fmax3(cmn2, rlo[id]);
              cmx2 = fmin3(cmx2, rhi[id]);
              if (cmx2.x < cmn2.x || cmx2.y < cmn2.y || cmx2.z < cmn2.z)
                continue;
              bl[b] = fmin3(bl[b], cmn2);
              bh[b] = fmax3(bh[b], cmx2);
            }
          }
          F3 suf_lo[kSahBins], suf_hi[kSahBins];
          int64_t suf_n[kSahBins];
          F3 rl = bl[kSahBins - 1], rh = bh[kSahBins - 1];
          int64_t rn = exit_[kSahBins - 1];
          for (int b = kSahBins - 1; b >= 0; --b) {
            if (b < kSahBins - 1) {
              rl = fmin3(rl, bl[b]);
              rh = fmax3(rh, bh[b]);
              rn += exit_[b];
            }
            suf_lo[b] = rl;
            suf_hi[b] = rh;
            suf_n[b] = rn;
          }
          F3 pl = bl[0], ph = bh[0];
          int64_t pn = entry[0];
          for (int s = 0; s < kSahBins - 1; ++s) {
            if (s > 0) {
              pl = fmin3(pl, bl[s]);
              ph = fmax3(ph, bh[s]);
              pn += entry[s];
            }
            if (pn == 0 || suf_n[s + 1] == 0) continue;
            float cost = surface(pl, ph) * pn
                         + surface(suf_lo[s + 1], suf_hi[s + 1]) * suf_n[s + 1];
            if (cost < best_cost && cost < sp_cost) {
              sp_cost = cost;
              sp_axis = axis;
              sp_plane = nbm[axis] + (s + 1) * w;
            }
          }
        }
      }
    }

    if (best_axis < 0 && sp_axis < 0) {
      make_leaf(node, ids);
      return node;
    }

    std::vector<int32_t> lids, rids;
    if (sp_axis >= 0) {
      // spatial split: straddlers clipped into both children
      std::vector<int32_t> strad;
      for (int32_t id : ids) {
        if (axis_of(rhi[id], sp_axis) <= sp_plane)
          lids.push_back(id);
        else if (axis_of(rlo[id], sp_axis) >= sp_plane)
          rids.push_back(id);
        else
          strad.push_back(id);
      }
      if (!strad.empty() && ref_tri.size() + strad.size() <= max_refs) {
        for (int32_t id : strad) {
          F3 lmn, lmx, rmn, rmx;
          bool okl = clip_tri(ref_tri[id], sp_axis, -1e30f, sp_plane,
                              lmn, lmx);
          bool okr = clip_tri(ref_tri[id], sp_axis, sp_plane, 1e30f,
                              rmn, rmx);
          if (okl) {
            lmn = fmax3(lmn, rlo[id]);
            lmx = fmin3(lmx, rhi[id]);
            okl = lmx.x >= lmn.x && lmx.y >= lmn.y && lmx.z >= lmn.z;
          }
          if (okr) {
            rmn = fmax3(rmn, rlo[id]);
            rmx = fmin3(rmx, rhi[id]);
            okr = rmx.x >= rmn.x && rmx.y >= rmn.y && rmx.z >= rmn.z;
          }
          if (okl && okr) {
            // left reuses the row; right gets a fresh ref
            rlo[id] = lmn;
            rhi[id] = lmx;
            lids.push_back(id);
            int32_t nid = (int32_t)ref_tri.size();
            ref_tri.push_back(ref_tri[id]);
            rlo.push_back(rmn);
            rhi.push_back(rmx);
            rids.push_back(nid);
          } else if (okl) {
            rlo[id] = lmn;
            rhi[id] = lmx;
            lids.push_back(id);
          } else if (okr) {
            rlo[id] = rmn;
            rhi[id] = rmx;
            rids.push_back(id);
          } else {
            lids.push_back(id);  // never drop a ref
          }
        }
      } else {
        sp_axis = -1;  // budget exhausted -> object split below
        lids.clear();
        rids.clear();
      }
      if (sp_axis >= 0 && (lids.empty() || rids.empty())) {
        sp_axis = -1;
        lids.clear();
        rids.clear();
      }
    }
    if (sp_axis < 0) {
      // object split along best_axis at best_split
      float inv = (float)kSahBins / cext[best_axis];
      for (size_t i = 0; i < cnt; ++i) {
        int b = std::min((int)((axis_of(cent[i], best_axis)
                                - cmin_a[best_axis]) * inv),
                         kSahBins - 1);
        (b <= best_split ? lids : rids).push_back(ids[i]);
      }
      if (lids.empty() || rids.empty()) {
        // median fallback for degenerate binning
        lids.clear();
        rids.clear();
        std::vector<std::pair<float, int32_t>> keyed(cnt);
        for (size_t i = 0; i < cnt; ++i)
          keyed[i] = {axis_of(cent[i], best_axis), ids[i]};
        std::nth_element(keyed.begin(), keyed.begin() + cnt / 2,
                         keyed.end());
        for (size_t i = 0; i < cnt; ++i)
          (i < cnt / 2 ? lids : rids).push_back(keyed[i].second);
      }
    }
    ids.clear();
    ids.shrink_to_fit();
    offset[node] = 0;
    count[node] = 0;
    int l = recurse(std::move(lids), depth + 1);
    int r = recurse(std::move(rids), depth + 1);
    left[node] = l;
    right[node] = r;
    return node;
  }
};

}  // namespace

extern "C" int dsrt_build_sbvh(const float* v0, const float* v1,
                               const float* v2, int n, float alpha,
                               float ref_budget, int32_t cap_nodes,
                               int32_t cap_refs, float* out_bmin,
                               float* out_bmax, int32_t* out_left,
                               int32_t* out_right, int32_t* out_offset,
                               int32_t* out_count, int32_t* out_indices,
                               int32_t* n_refs_out) {
  if (n <= 0) return 0;
  SBuilder b;
  b.v0 = v0;
  b.v1 = v1;
  b.v2 = v2;
  b.n = n;
  b.alpha = alpha;
  b.max_refs = (size_t)(ref_budget * n);
  b.prepare();
  std::vector<int32_t> root(n);
  for (int i = 0; i < n; ++i) root[i] = i;
  b.recurse(std::move(root), 1);

  int n_nodes = (int)b.bmin.size();
  int n_refs = (int)b.out_refs.size();
  if (n_nodes > cap_nodes || n_refs > cap_refs) return -1;
  for (int i = 0; i < n_nodes; ++i) {
    out_bmin[3 * i] = b.bmin[i].x;
    out_bmin[3 * i + 1] = b.bmin[i].y;
    out_bmin[3 * i + 2] = b.bmin[i].z;
    out_bmax[3 * i] = b.bmax[i].x;
    out_bmax[3 * i + 1] = b.bmax[i].y;
    out_bmax[3 * i + 2] = b.bmax[i].z;
    out_left[i] = b.left[i];
    out_right[i] = b.right[i];
    out_offset[i] = b.offset[i];
    out_count[i] = b.count[i];
  }
  std::copy(b.out_refs.begin(), b.out_refs.end(), out_indices);
  *n_refs_out = n_refs;
  return n_nodes;
}

extern "C" int dsrt_build_bvh(const float* v0, const float* v1,
                              const float* v2, int n, int method,
                              float* out_bmin, float* out_bmax,
                              int32_t* out_left, int32_t* out_right,
                              int32_t* out_offset, int32_t* out_count,
                              int32_t* out_indices) {
  if (n <= 0) return 0;
  Builder b;
  b.v0 = v0;
  b.v1 = v1;
  b.v2 = v2;
  b.n = n;
  b.prepare();
  b.bmin.reserve(2 * n);
  b.bmax.reserve(2 * n);
  b.left.reserve(2 * n);
  b.right.reserve(2 * n);
  b.offset.reserve(2 * n);
  b.count.reserve(2 * n);

  if (method == 1)
    b.build_sah(0, n, 0);
  else
    b.build_median(0, n);

  int n_nodes = (int)b.bmin.size();
  if (n_nodes > 2 * n) return -1;  // caller allocated 2n capacity
  for (int i = 0; i < n_nodes; ++i) {
    out_bmin[3 * i] = b.bmin[i].x;
    out_bmin[3 * i + 1] = b.bmin[i].y;
    out_bmin[3 * i + 2] = b.bmin[i].z;
    out_bmax[3 * i] = b.bmax[i].x;
    out_bmax[3 * i + 1] = b.bmax[i].y;
    out_bmax[3 * i + 2] = b.bmax[i].z;
    out_left[i] = b.left[i];
    out_right[i] = b.right[i];
    out_offset[i] = b.offset[i];
    out_count[i] = b.count[i];
  }
  std::copy(b.indices.begin(), b.indices.end(), out_indices);
  return n_nodes;
}
