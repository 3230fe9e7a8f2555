// CPU baseline for the benchmark denominator.
//
// A faithful single-process C++ port of the reference FLIP pipeline
// (Aakash1312/Fluid-Simulation fluid.cc) scaled to an arbitrary grid size, as
// required by BASELINE.md ("porting the reference scene config up to 128^3
// and timing it as the denominator").  Same per-frame work as the JAX path:
//   quadratic-support spline P2G scatter -> occupancy -> pressure do-while
//   (rhs/divergence/7-point Laplacian, Jacobi-PCG) -> FLIP gather -> CFL ->
//   advect with solid bounce.
// The pressure solve is matrix-free Jacobi-PCG (rtol 1e-5) rather than
// Eigen's assembled IncompleteCholesky solve; on dense boxes this is at
// least as fast (no per-iteration sparse assembly), so the baseline is not
// handicapped.
//
// Threading: the reference parallelizes exactly its particle loops over TBB
// (fluid.cc:845-1126) while all grid sweeps and the linear solve run serial.
// This port mirrors that split with OpenMP (compile with -fopenmp): the P2G
// scatter uses atomic adds (the analog of the reference's per-voxel mutex
// cube, fluid.cc:828-836), and the FLIP gather / advect loops are
// embarrassingly parallel.  The port also times the particle phase
// separately and reports an Amdahl bound — the steps/s an infinitely-
// threaded reference could reach with the serial grid/solve fraction
// unchanged — so the benchmark denominator is honest even on a single-core
// driver machine.
//
// Usage: ref_cpu <bound> <density> <frames> [particle_file] [--perframe=FILE]
// Prints one JSON line: {"steps_per_sec": ..., "amdahl_bound_steps_per_sec":
// ..., ...}
// With --perframe=FILE, every frame's wall seconds (and its particle-phase
// seconds, for a per-window Amdahl bound) are appended to FILE as JSONL and
// the warmup frame is skipped, so windowed sustained-throughput numbers
// (e.g. post-impact frames 50-70, full-500 average) can be extracted from a
// single long run.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>
#include <chrono>
#ifdef _OPENMP
#include <omp.h>
#endif

// Wall-clock accumulated inside the particle-parallel loops (the part the
// reference runs over TBB); everything else is the serial fraction.
static double g_particle_secs = 0.0;
struct PhaseTimer {
  std::chrono::steady_clock::time_point t0;
  PhaseTimer() : t0(std::chrono::steady_clock::now()) {}
  ~PhaseTimer() {
    g_particle_secs +=
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
            .count();
  }
};

static inline double spline(double x) {  // fluid.cc:22-37
  double a = std::fabs(x);
  if (a < 0.5) return 1.5 * (4 * a * a * a - 4 * a * a + 2.0 / 3.0);
  if (a < 1.0) return 1.5 * (-8.0 * a * a * a / 6.0 + 4 * a * a - 4 * a + 4.0 / 3.0);
  return 0.0;
}

struct Sim {
  int B, N, wall;
  double dx = 1.0, rho = 1.0, maxdt = 0.1, g = -10.0;
  std::vector<float> u, v, w, wsum, occ, rhs, div, adiag, p;
  std::vector<float> r, z, d, q;  // pcg workspaces
  std::vector<uint8_t> solid, fluid;
  std::vector<float> px, py, pz, vx, vy, vz;

  inline size_t idx(int x, int y, int z) const {
    return ((size_t)(x + B) * N + (y + B)) * N + (z + B);
  }
  inline bool isSolid(int x, int y, int z) const {
    if (std::abs(x) > B || std::abs(y) > B || std::abs(z) > B) return false;
    return solid[idx(x, y, z)] != 0;
  }

  Sim(int bound, double density) : B(bound), N(2 * bound + 1), wall(bound - 2) {
    size_t n3 = (size_t)N * N * N;
    for (auto* a : {&u, &v, &w, &wsum, &occ, &rhs, &div, &adiag, &p, &r, &z, &d, &q})
      a->assign(n3, 0.f);
    solid.assign(n3, 0);
    fluid.assign(n3, 0);
    for (int x = -B; x <= B; ++x)
      for (int y = -B; y <= B; ++y)
        for (int zc = -B; zc <= B; ++zc)
          if (std::abs(x) > wall || std::abs(y) > wall || std::abs(zc) > wall)
            solid[idx(x, y, zc)] = 1;
    // seed: density ppv over the centred cube of half-width B/3 (fluid.cc:1176,1348)
    int cube = B / 3;
    std::mt19937 rng(0);
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    long voxels = (2L * cube + 1) * (2L * cube + 1) * (2L * cube + 1);
    long target = (long)density * voxels;
    px.reserve(target);
    for (long i = 0; i < target; ++i) {
      double cx = std::floor(uni(rng) * (2 * cube + 1)) - cube;
      double cy = std::floor(uni(rng) * (2 * cube + 1)) - cube;
      double cz = std::floor(uni(rng) * (2 * cube + 1)) - cube;
      double x = cx - 0.5 + uni(rng), y = cy - 0.5 + uni(rng), zc = cz - 0.5 + uni(rng);
      if (std::fabs(x) < B - 2 && std::fabs(y) < B - 2 && std::fabs(zc) < B - 2) {
        px.push_back(x); py.push_back(y); pz.push_back(zc);
        vx.push_back(0); vy.push_back(0); vz.push_back(0);
      }
    }
  }

  void p2g() {
    std::fill(u.begin(), u.end(), 0.f);
    std::fill(v.begin(), v.end(), 0.f);
    std::fill(w.begin(), w.end(), 0.f);
    std::fill(wsum.begin(), wsum.end(), 0.f);
    std::fill(occ.begin(), occ.end(), 0.f);
    {
      PhaseTimer pt;  // particle-parallel phase (reference: fluid.cc:1126)
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
      for (long i = 0; i < (long)px.size(); ++i) {
        int cx = (int)std::lround(px[i]), cy = (int)std::lround(py[i]),
            cz = (int)std::lround(pz[i]);
        for (int a = cx - 1; a <= cx + 1; ++a)
          for (int b = cy - 1; b <= cy + 1; ++b)
            for (int c = cz - 1; c <= cz + 1; ++c) {
              if (std::abs(a) > B || std::abs(b) > B || std::abs(c) > B) continue;
              if (isSolid(a, b, c)) continue;
              double cw = spline(px[i] - a) * spline(py[i] - b) * spline(pz[i] - c);
              size_t k = idx(a, b, c);
              // atomic adds = the per-voxel mutex cube (fluid.cc:828-836)
              if (cw > 0) {
#ifdef _OPENMP
#pragma omp atomic
#endif
                occ[k] += (float)cw;
              }
              if (std::abs(a) <= B - 2 && std::abs(b) <= B - 2 && std::abs(c) <= B - 2) {
                float fw = (float)cw, fu = (float)(cw * vx[i]),
                      fv = (float)(cw * vy[i]), fwv = (float)(cw * vz[i]);
#ifdef _OPENMP
#pragma omp atomic
#endif
                wsum[k] += fw;
#ifdef _OPENMP
#pragma omp atomic
#endif
                u[k] += fu;
#ifdef _OPENMP
#pragma omp atomic
#endif
                v[k] += fv;
#ifdef _OPENMP
#pragma omp atomic
#endif
                w[k] += fwv;
              }
            }
      }
    }
    size_t n3 = (size_t)N * N * N;
    for (size_t k = 0; k < n3; ++k)
      if (wsum[k] > 0) { u[k] /= wsum[k]; v[k] /= wsum[k]; w[k] /= wsum[k]; }
    for (size_t k = 0; k < n3; ++k) fluid[k] = (occ[k] > 0 && !solid[k]);
  }

  void build_system(double dt) {
    double s = 1.0 / dx, a_s = dt / (rho * dx * dx);
    for (int x = -B; x <= B; ++x)
      for (int y = -B; y <= B; ++y)
        for (int zc = -B; zc <= B; ++zc) {
          size_t k = idx(x, y, zc);
          rhs[k] = 0; div[k] = 0; adiag[k] = 0;
          if (!fluid[k]) continue;
          double gdt = g * dt;
          if (isSolid(x - 1, y, zc)) rhs[k] -= (float)(s * u[k]);
          if (isSolid(x + 1, y, zc)) rhs[k] += (float)(s * u[idx(x + 1, y, zc)]);
          if (isSolid(x, y - 1, zc)) rhs[k] -= (float)(s * (v[k] + gdt));
          if (isSolid(x, y + 1, zc)) rhs[k] += (float)(s * (v[idx(x, y + 1, zc)] + gdt));
          if (isSolid(x, y, zc - 1)) rhs[k] -= (float)(s * w[k]);
          if (isSolid(x, y, zc + 1)) rhs[k] += (float)(s * w[idx(x, y, zc + 1)]);
          double dv = 0;
          if (!isSolid(x + 1, y, zc)) dv += (u[idx(x + 1, y, zc)] - u[k]) / dx;
          if (!isSolid(x, y + 1, zc)) dv += (v[idx(x, y + 1, zc)] - v[k]) / dx;
          if (!isSolid(x, y, zc + 1)) dv += (w[idx(x, y, zc + 1)] - w[k]) / dx;
          div[k] = rhs[k] - (float)dv;
          int cnt = 0;
          cnt += !isSolid(x + 1, y, zc); cnt += !isSolid(x - 1, y, zc);
          cnt += !isSolid(x, y + 1, zc); cnt += !isSolid(x, y - 1, zc);
          cnt += !isSolid(x, y, zc + 1); cnt += !isSolid(x, y, zc - 1);
          adiag[k] = (float)(a_s * cnt);
        }
  }

  void applyA(const std::vector<float>& in, std::vector<float>& out, double dt) {
    double a_s = dt / (rho * dx * dx);
    for (int x = -B; x <= B; ++x)
      for (int y = -B; y <= B; ++y)
        for (int zc = -B; zc <= B; ++zc) {
          size_t k = idx(x, y, zc);
          if (!fluid[k]) { out[k] = 0; continue; }
          double acc = adiag[k] * in[k];
          auto nb = [&](int a, int b, int c) -> double {
            if (std::abs(a) > B || std::abs(b) > B || std::abs(c) > B) return 0.0;
            size_t j = idx(a, b, c);
            return fluid[j] ? in[j] : 0.0;
          };
          acc -= a_s * (nb(x + 1, y, zc) + nb(x - 1, y, zc) + nb(x, y + 1, zc) +
                        nb(x, y - 1, zc) + nb(x, y, zc + 1) + nb(x, y, zc - 1));
          out[k] = (float)acc;
        }
  }

  int pcg(double dt, double rtol, int maxiter) {
    size_t n3 = (size_t)N * N * N;
    std::fill(p.begin(), p.end(), 0.f);
    double bn2 = 0;
    for (size_t k = 0; k < n3; ++k) { r[k] = div[k]; bn2 += (double)r[k] * r[k]; }
    if (bn2 == 0) return 0;
    double tol2 = rtol * rtol * bn2;
    for (size_t k = 0; k < n3; ++k) z[k] = adiag[k] > 0 ? r[k] / adiag[k] : 0.f;
    d = z;
    double rz = 0;
    for (size_t k = 0; k < n3; ++k) rz += (double)r[k] * z[k];
    int it = 0;
    for (; it < maxiter; ++it) {
      double rr = 0;
      for (size_t k = 0; k < n3; ++k) rr += (double)r[k] * r[k];
      if (rr <= tol2) break;
      applyA(d, q, dt);
      double dq = 0;
      for (size_t k = 0; k < n3; ++k) dq += (double)d[k] * q[k];
      double alpha = dq != 0 ? rz / dq : 0;
      for (size_t k = 0; k < n3; ++k) { p[k] += (float)(alpha * d[k]); r[k] -= (float)(alpha * q[k]); }
      for (size_t k = 0; k < n3; ++k) z[k] = adiag[k] > 0 ? r[k] / adiag[k] : 0.f;
      double rz2 = 0;
      for (size_t k = 0; k < n3; ++k) rz2 += (double)r[k] * z[k];
      double beta = rz != 0 ? rz2 / rz : 0;
      for (size_t k = 0; k < n3; ++k) d[k] = z[k] + (float)(beta * d[k]);
      rz = rz2;
    }
    return it;
  }

  double project(double dt) {  // fluid.cc:1457-1484 do-while
    double err = 1e30;
    int outer = 0;
    while (err > 0.1 && outer < 100) {
      build_system(dt);
      std::vector<float> b = div;
      pcg(dt, 1e-5, 400);
      // velUpdate with dt/10 + gravity per pass (fluid.cc:612-703,1475)
      double s2 = (dt / 10.0) / (rho * dx);
      for (int x = -B; x <= B; ++x)
        for (int y = -B; y <= B; ++y)
          for (int zc = -B; zc <= B; ++zc) {
            size_t k = idx(x, y, zc);
            if (fluid[k]) {
              float pv = p[k];
              u[k] -= (float)(s2 * pv); v[k] -= (float)(s2 * pv); w[k] -= (float)(s2 * pv);
              v[k] += (float)(g * dt);
              if (x + 1 <= B) u[idx(x + 1, y, zc)] += (float)(s2 * pv);
              if (y + 1 <= B) v[idx(x, y + 1, zc)] += (float)(s2 * pv);
              if (zc + 1 <= B) w[idx(x, y, zc + 1)] += (float)(s2 * pv);
            }
          }
      for (int x = -B; x <= B; ++x)
        for (int y = -B; y <= B; ++y)
          for (int zc = -B; zc <= B; ++zc) {
            size_t k = idx(x, y, zc);
            if (solid[k]) { u[k] = v[k] = w[k] = 0; }
            if (isSolid(x - 1, y, zc)) u[k] = 0;
            if (isSolid(x, y - 1, zc)) v[k] = 0;
            if (isSolid(x, y, zc - 1)) w[k] = 0;
          }
      build_system(dt);
      double num = 0, den = 0;
      for (size_t k = 0; k < b.size(); ++k) {
        double dd = (double)b[k] - div[k];
        num += dd * dd;
        den += (double)b[k] * b[k];
      }
      err = den > 0 ? std::sqrt(num) / std::sqrt(den) : 0.0;
      ++outer;
    }
    return err;
  }

  double flip_advect(const std::vector<float>& ub, const std::vector<float>& vb,
                     const std::vector<float>& wb, double dt_prev) {
    auto center = [&](const std::vector<float>& uu, const std::vector<float>& vv,
                      const std::vector<float>& ww, int a, int b, int c, double out[3]) {
      size_t k = idx(a, b, c);
      double up = (a + 1 <= B) ? uu[idx(a + 1, b, c)] : 0.0;
      double vp = (b + 1 <= B) ? vv[idx(a, b + 1, c)] : 0.0;
      double wp = (c + 1 <= B) ? ww[idx(a, b, c + 1)] : 0.0;
      out[0] = 0.5 * (uu[k] + up); out[1] = 0.5 * (vv[k] + vp); out[2] = 0.5 * (ww[k] + wp);
    };
    double maxspeed = 0;
    {
      PhaseTimer pt;  // particle-parallel phase (reference: fluid.cc:978)
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(max : maxspeed)
#endif
      for (long i = 0; i < (long)px.size(); ++i) {
        int cx = (int)std::lround(px[i]), cy = (int)std::lround(py[i]),
            cz = (int)std::lround(pz[i]);
        double weight = 0, del[3] = {0, 0, 0};
        for (int a = cx - 1; a <= cx + 1; ++a)
          for (int b = cy - 1; b <= cy + 1; ++b)
            for (int c = cz - 1; c <= cz + 1; ++c) {
              if (std::abs(a) > wall || std::abs(b) > wall || std::abs(c) > wall) continue;
              double cn[3], co[3];
              center(u, v, w, a, b, c, cn);
              center(ub, vb, wb, a, b, c, co);
              double cw = spline(px[i] - a) * spline(py[i] - b) * spline(pz[i] - c);
              weight += cw;
              for (int dd = 0; dd < 3; ++dd) del[dd] += (cn[dd] - co[dd]) * cw;
            }
        if (weight != 0)
          for (int dd = 0; dd < 3; ++dd) del[dd] /= weight;
        vx[i] += (float)del[0]; vy[i] += (float)del[1]; vz[i] += (float)del[2];
        double sp = std::sqrt((double)vx[i] * vx[i] + (double)vy[i] * vy[i] + (double)vz[i] * vz[i]);
        if (sp > maxspeed) maxspeed = sp;
      }
    }
    double dt = maxspeed != 0 ? std::min(maxdt, dx / maxspeed) : maxdt;
    {
      PhaseTimer pt;  // particle-parallel phase (reference: fluid.cc:1000)
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
      for (long i = 0; i < (long)px.size(); ++i) {
        double nx = px[i] + dt * vx[i], ny = py[i] + dt * vy[i], nz = pz[i] + dt * vz[i];
        int rx = (int)std::lround(nx), ry = (int)std::lround(ny), rz = (int)std::lround(nz);
        if (isSolid(rx, ry, rz)) {
          if (isSolid(rx, (int)py[i], (int)pz[i])) vx[i] = 0;
          if (isSolid((int)px[i], ry, (int)pz[i])) vy[i] = 0;
          if (isSolid((int)px[i], (int)py[i], rz)) vz[i] = 0;
          px[i] += (float)(dt * vx[i]); py[i] += (float)(dt * vy[i]); pz[i] += (float)(dt * vz[i]);
        } else {
          px[i] = (float)nx; py[i] = (float)ny; pz[i] = (float)nz;
        }
      }
    }
    return dt;
  }
};

int main(int argc, char** argv) {
  const char* perframe_path = nullptr;
  std::vector<const char*> pos;
  for (int i = 1; i < argc; ++i) {
    if (std::strncmp(argv[i], "--perframe=", 11) == 0)
      perframe_path = argv[i] + 11;
    else
      pos.push_back(argv[i]);
  }
  int bound = pos.size() > 0 ? std::atoi(pos[0]) : 64;
  double density = pos.size() > 1 ? std::atof(pos[1]) : 25.0;
  int frames = pos.size() > 2 ? std::atoi(pos[2]) : 3;
  const char* particle_file = pos.size() > 3 ? pos[3] : nullptr;
  bool trace_ke = particle_file != nullptr;

  Sim sim(bound, density);
  if (particle_file) {
    // cross-validation mode: load positions (P x 3 float32) so the Python
    // framework and this port run the identical initial state.
    FILE* f = fopen(particle_file, "rb");
    if (!f) { fprintf(stderr, "cannot open %s\n", particle_file); return 1; }
    fseek(f, 0, SEEK_END);
    long bytes = ftell(f);
    fseek(f, 0, SEEK_SET);
    size_t p = bytes / (3 * sizeof(float));
    std::vector<float> buf(p * 3);
    if (fread(buf.data(), sizeof(float), p * 3, f) != p * 3) return 1;
    fclose(f);
    sim.px.assign(p, 0); sim.py.assign(p, 0); sim.pz.assign(p, 0);
    sim.vx.assign(p, 0); sim.vy.assign(p, 0); sim.vz.assign(p, 0);
    for (size_t i = 0; i < p; ++i) {
      sim.px[i] = buf[3 * i]; sim.py[i] = buf[3 * i + 1]; sim.pz[i] = buf[3 * i + 2];
    }
  }
  fprintf(stderr, "# ref_cpu: grid %d^3, %zu particles, %d frames\n",
          sim.N, sim.px.size(), frames);
  double dt = sim.maxdt;
  if (!trace_ke && !perframe_path) {
    // one warmup frame (touch all memory) before timing
    sim.p2g();
    sim.project(dt);
    auto ub = sim.u, vb = sim.v, wb = sim.w;
    dt = sim.flip_advect(ub, vb, wb, dt);
  }
  FILE* pf = nullptr;
  if (perframe_path) {
    pf = fopen(perframe_path, "w");
    if (!pf) { fprintf(stderr, "cannot open %s\n", perframe_path); return 1; }
  }

  g_particle_secs = 0.0;
  auto t0 = std::chrono::steady_clock::now();
  for (int f = 0; f < frames; ++f) {
    double psec0 = g_particle_secs;
    auto tf0 = std::chrono::steady_clock::now();
    sim.p2g();
    auto ub = sim.u; auto vb = sim.v; auto wb = sim.w;
    sim.project(dt);
    dt = sim.flip_advect(ub, vb, wb, dt);
    if (pf) {
      double fsecs = std::chrono::duration<double>(
          std::chrono::steady_clock::now() - tf0).count();
      double ke = 0;
      for (size_t i = 0; i < sim.px.size(); ++i)
        ke += 0.5 * ((double)sim.vx[i] * sim.vx[i] + (double)sim.vy[i] * sim.vy[i]
                     + (double)sim.vz[i] * sim.vz[i]);
      fprintf(pf, "{\"frame\": %d, \"secs\": %.6f, \"particle_secs\": %.6f, "
              "\"ke\": %.8e, \"dt\": %.8f}\n",
              f, fsecs, g_particle_secs - psec0, ke, dt);
      fflush(pf);
    }
    if (trace_ke) {
      double ke = 0;
      for (size_t i = 0; i < sim.px.size(); ++i)
        ke += 0.5 * ((double)sim.vx[i] * sim.vx[i] + (double)sim.vy[i] * sim.vy[i]
                     + (double)sim.vz[i] * sim.vz[i]);
      printf("{\"frame\": %d, \"ke\": %.8e, \"dt\": %.8f}\n", f, ke, dt);
    }
  }
  if (pf) fclose(pf);
  if (!trace_ke) {
    double total = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count();
    double secs = total / frames;
    // Amdahl bound: the reference threads ONLY its particle loops (TBB,
    // fluid.cc:845-1126); grid sweeps + CG are serial.  With the particle
    // fraction reduced to zero, a frame still costs the serial fraction —
    // the fastest any thread count could make the reference on this CPU.
    double frac_particle = total > 0 ? g_particle_secs / total : 0.0;
    double serial_secs = secs * (1.0 - frac_particle);
    int nthreads = 1;
#ifdef _OPENMP
    nthreads = omp_get_max_threads();
#endif
    printf("{\"steps_per_sec\": %.6f, \"ms_per_frame\": %.1f, \"particles\": %zu, "
           "\"grid\": %d, \"frames\": %d, \"threads\": %d, "
           "\"particle_fraction\": %.4f, "
           "\"amdahl_bound_steps_per_sec\": %.6f, "
           "\"method\": \"C++ port of reference FLIP pipeline, matrix-free "
           "Jacobi-PCG rtol 1e-5; particle loops OpenMP-parallel (TBB analog), "
           "grid sweeps and CG serial as in the reference\"}\n",
           1.0 / secs, secs * 1000.0, sim.px.size(), sim.N, frames, nthreads,
           frac_particle, serial_secs > 0 ? 1.0 / serial_secs : 0.0);
  }
  return 0;
}
