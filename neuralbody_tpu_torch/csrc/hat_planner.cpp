// Native hat-interpolation planner: the per-batch host hot path.
//
// Mirrors neuralbody_tpu/ops/hat_interp.py::plan_hat_groups exactly for the
// steady-state case (static caps known): bucket ray samples into spatial
// tiles, chunk tiles into fixed-size point groups, and emit per-(level,
// group) site-row SEGMENTS — (start, cumulative-length) pairs over the
// code-sorted site table — whose hat support can touch the group. The
// vectorized numpy planner costs ~40 ms/batch at the reference working
// point (1024 rays x 64 samples) on this 2-vCPU host — too slow to feed a
// ~22 ms/step device; this single pass runs in ~2-4 ms. Segments (not
// expanded row lists) are also what ships to the device: ~6-12x fewer
// bytes over the production-limiting host->TPU link; the device expands
// them back (ops/hat_interp.py expand_segments).
//
// Contract tested against the numpy planner bit-for-bit in
// tests/test_hat_planner_native.py. Derive mode (caps unknown) stays in
// numpy — it runs once per sequence.
//
// Replaces host-side work the reference does per batch in its DataLoader
// workers (ref lib/datasets/make_dataset.py:66-67); the reference has no
// planner because its CUDA grid_sample gathers directly.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns 0 on success, 1 = group overflow, 2 = total-rows overflow,
// 3 = segment-count overflow (overflow level in *err_lvl). All outputs
// preallocated by the caller:
//   perm    [n_groups * P] int32
//   seg_a   [4] pointers, seg_a[li]   = [n_groups, seg_caps[li]] int32
//   seg_cum [4] pointers, seg_cum[li] = [n_groups, seg_caps[li]] int32
int plan_hat_segments(
    const float* dhw,        // [N, 3] full-res continuous voxel coords
    int64_t N,
    const int32_t* out_sh,   // [3]
    int32_t P,               // group size
    const int32_t* tile,     // [3]; tile[2] == 0 -> 2D tiles
    const int32_t* const* sites,  // [4], each [nsite[li], 3] sorted by code
    const int32_t* nsite,    // [4]
    const int32_t* rows_caps,     // [4] total-rows cap (device expansion)
    const int32_t* seg_caps,      // [4] segment-count cap
    int32_t n_groups,
    int32_t* perm,
    int32_t* const* seg_a,
    int32_t* const* seg_cum,
    int32_t* err_lvl) {
  *err_lvl = -1;
  // ---- level-1 scales and tile ids -----------------------------------
  const int D1 = out_sh[0] / 2, H1 = out_sh[1] / 2, W1 = out_sh[2] / 2;
  // float32 arithmetic to match numpy's _level_scale/pos1 exactly
  float s1[3] = {
      float((double(D1) - 1.0) / double(out_sh[0])),
      float((double(H1) - 1.0) / double(out_sh[1])),
      float((double(W1) - 1.0) / double(out_sh[2]))};
  const bool tiles3d = tile[2] > 0;
  const int64_t n_th = (H1 + tile[1] - 1) / tile[1];
  const int64_t n_tw = tiles3d ? (W1 + tile[2] - 1) / tile[2] : 1;
  const int64_t n_td = (D1 + tile[0] - 1) / tile[0];
  const int64_t n_tiles = n_td * n_th * n_tw;

  std::vector<int64_t> tid(N);
  for (int64_t i = 0; i < N; ++i) {
    float pd = dhw[3 * i] * s1[0];
    float ph = dhw[3 * i + 1] * s1[1];
    int64_t dc = (int64_t)std::floor(pd);
    int64_t hc = (int64_t)std::floor(ph);
    dc = std::min(std::max(dc, (int64_t)0), (int64_t)(D1 - 1));
    hc = std::min(std::max(hc, (int64_t)0), (int64_t)(H1 - 1));
    int64_t t = (dc / tile[0]) * n_th + hc / tile[1];
    if (tiles3d) {
      float pw = dhw[3 * i + 2] * s1[2];
      int64_t wc = (int64_t)std::floor(pw);
      wc = std::min(std::max(wc, (int64_t)0), (int64_t)(W1 - 1));
      t = t * n_tw + wc / tile[2];
    }
    tid[i] = t;
  }

  // ---- stable counting sort by tile id -------------------------------
  std::vector<int64_t> cnt(n_tiles + 1, 0);
  for (int64_t i = 0; i < N; ++i) cnt[tid[i] + 1]++;
  // compact to occupied tiles preserving tile order (matches np.argsort
  // stable over tile_id): offsets over ALL tiles is fine
  for (int64_t t = 0; t < n_tiles; ++t) cnt[t + 1] += cnt[t];
  std::vector<int32_t> order(N);
  {
    std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < N; ++i) order[cur[tid[i]]++] = (int32_t)i;
  }

  // ---- pad each tile's chunk to a multiple of P ------------------------
  int64_t used = 0;  // groups used
  {
    int64_t pos = 0;  // write cursor into perm
    const int64_t max_slots = (int64_t)n_groups * P;
    for (int64_t t = 0; t < n_tiles; ++t) {
      const int64_t a = cnt[t], b = cnt[t + 1];
      const int64_t c = b - a;
      if (!c) continue;
      const int64_t padded = ((c + P - 1) / P) * P;
      if (pos + padded > max_slots) return 1;  // group overflow
      for (int64_t k = 0; k < padded; ++k)
        perm[pos + k] = order[a + (k < c ? k : 0)];
      pos += padded;
    }
    used = pos / P;
    // inert padding groups repeat point 0
    std::memset(perm + pos, 0,
                sizeof(int32_t) * (size_t)(max_slots - pos));
  }
  (void)used;

  // ---- per-group full-res bbox ----------------------------------------
  std::vector<float> gmin((size_t)n_groups * 3), gmax((size_t)n_groups * 3);
  for (int64_t g = 0; g < n_groups; ++g) {
    float mn[3] = {3e38f, 3e38f, 3e38f}, mx[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t k = 0; k < P; ++k) {
      const float* p = dhw + 3 * (int64_t)perm[g * P + k];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], p[a]);
        mx[a] = std::max(mx[a], p[a]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      gmin[g * 3 + a] = mn[a];
      gmax[g * 3 + a] = mx[a];
    }
  }

  // ---- per-level row lists --------------------------------------------
  for (int li = 0; li < 4; ++li) {
    const int lvl = li + 1;
    const int64_t Dl = out_sh[0] >> lvl, Hl = out_sh[1] >> lvl,
                  Wl = out_sh[2] >> lvl;
    float sl[3] = {float((double(Dl) - 1.0) / double(out_sh[0])),
                   float((double(Hl) - 1.0) / double(out_sh[1])),
                   float((double(Wl) - 1.0) / double(out_sh[2]))};
    const int64_t ns = nsite[li];
    const int32_t* st = sites[li];
    // (d, h)-bucket prefix index + per-site w keys: segments become tiny
    // binary searches inside one bucket instead of lower_bound over the
    // whole level table (3D tiles emit (d-range x h-range) segments per
    // group; the global searches dominated the plan at ~8 ms/batch)
    std::vector<int64_t> dh_off((size_t)(Dl * Hl + 1), 0);
    std::vector<int32_t> wkey(ns);
    for (int64_t r = 0; r < ns; ++r) {
      dh_off[(size_t)((int64_t)st[3 * r] * Hl + st[3 * r + 1]) + 1]++;
      wkey[r] = st[3 * r + 2];
    }
    for (size_t t = 1; t < dh_off.size(); ++t) dh_off[t] += dh_off[t - 1];

    const int32_t rcap = rows_caps[li];
    const int32_t scap = seg_caps[li];
    int32_t* sa = seg_a[li];
    int32_t* scum = seg_cum[li];

    for (int64_t g = 0; g < n_groups; ++g) {
      // floor(min*s), floor(max*s)+1, clipped — float32 mul as numpy does
      int64_t lo[3], hi[3];
      for (int a = 0; a < 3; ++a) {
        lo[a] = (int64_t)std::floor(gmin[g * 3 + a] * sl[a]);
        hi[a] = (int64_t)std::floor(gmax[g * 3 + a] * sl[a]) + 1;
      }
      const int64_t lim[3] = {Dl, Hl, Wl};
      int64_t c_lo[3], c_hi[3];
      for (int a = 0; a < 3; ++a) {
        c_lo[a] = std::min(std::max(lo[a], (int64_t)0), lim[a] - 1);
        c_hi[a] = std::min(std::max(hi[a], (int64_t)0), lim[a] - 1);
      }
      int32_t* sa_g = sa + (size_t)g * scap;
      int32_t* sc_g = scum + (size_t)g * scap;
      int64_t n_seg = 0, total = 0;
      // emit one (start, len) segment per non-empty contiguous run;
      // cumulative lengths (what the device's binary search wants)
      auto emit = [&](int64_t a, int64_t b) -> int {
        if (b <= a) return 0;
        total += b - a;
        if (total > rcap) { *err_lvl = lvl; return 2; }
        if (n_seg >= scap) { *err_lvl = lvl; return 3; }
        sa_g[n_seg] = (int32_t)a;
        sc_g[n_seg] = (int32_t)total;
        ++n_seg;
        return 0;
      };
      int rc2 = 0;
      for (int64_t d = c_lo[0]; d <= c_hi[0] && !rc2; ++d) {
        if (tiles3d) {
          for (int64_t h = c_lo[1]; h <= c_hi[1] && !rc2; ++h) {
            const int64_t dh = d * Hl + h;
            const int64_t ba = dh_off[dh], bb = dh_off[dh + 1];
            const int64_t a =
                std::lower_bound(wkey.begin() + ba, wkey.begin() + bb,
                                 (int32_t)c_lo[2]) - wkey.begin();
            const int64_t b =
                std::lower_bound(wkey.begin() + ba, wkey.begin() + bb,
                                 (int32_t)(c_hi[2] + 1)) - wkey.begin();
            rc2 = emit(a, b);
          }
        } else {
          // all-w stripe: contiguous run between the (d, h_lo) bucket
          // start and the (d, h_hi) bucket end
          rc2 = emit(dh_off[d * Hl + c_lo[1]], dh_off[d * Hl + c_hi[1] + 1]);
        }
      }
      if (rc2) return rc2;
      // pad: starts 0, cums repeat the total
      for (int64_t s2 = n_seg; s2 < scap; ++s2) {
        sa_g[s2] = 0;
        sc_g[s2] = (int32_t)total;
      }
    }
  }
  return 0;
}

}  // extern "C"
