// Headless CPU-baseline driver for the reference admm-elastic library.
//
// Builds the BASELINE.json beam scene (neo-Hookean tet beam, ~5k tets)
// against the unmodified reference sources (compiled from /root/reference,
// with the missing mcloptlib/mclscene submodule surface provided by the
// shim headers in mcl_shim/). Reports steps/s and ADMM iterations/s plus a
// final-position checksum so this system's build can be trajectory-checked
// against the same scene.
//
// Usage: ref_driver [nx ny nz] [admm_iters] [n_steps] [model 0=linear 1=nh 2=stvk 3=cloth] [dumpfile]
// model 3 ignores nz and builds an (nx x ny) triangle sheet in the xz
// plane (y=0), corners at x=0 pinned, with the default strain limits.
// With a dumpfile, writes the full per-step trajectory (n_steps x dof
// doubles, raw little-endian) for trajectory-parity checks against this
// build.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <string>
#include <vector>

#include "MCL/MicroTimer.hpp"
#include "MCL/TetMesh.hpp"
#include "DynamicObject.hpp"
#include "PassiveObject.hpp"
#include "Solver.hpp"
#include "TetEnergyTerm.hpp"
#include "TriEnergyTerm.hpp"
#include "ExplicitForce.hpp"

using Vec3 = Eigen::Vector3d;

// Structured beam: nx*ny*nz cubes, 5 tets each, parity-alternating —
// matches admm_elastic_tpu.geometry.factory.make_tet_blocks.
static void make_beam(int nx, int ny, int nz, std::vector<double>& verts,
                      std::vector<int>& tets) {
  auto vid = [&](int i, int j, int k) {
    return (i * (ny + 1) + j) * (nz + 1) + k;
  };
  for (int i = 0; i <= nx; ++i)
    for (int j = 0; j <= ny; ++j)
      for (int k = 0; k <= nz; ++k) {
        verts.push_back(i);
        verts.push_back(j);
        verts.push_back(k);
      }
  const int even[5][4] = {{0, 1, 3, 5}, {0, 3, 2, 6}, {0, 5, 4, 6},
                          {3, 5, 6, 7}, {0, 3, 5, 6}};
  const int odd[5][4] = {{1, 2, 0, 4}, {1, 7, 3, 2}, {1, 4, 5, 7},
                         {2, 4, 6, 7}, {1, 2, 7, 4}};
  for (int i = 0; i < nx; ++i)
    for (int j = 0; j < ny; ++j)
      for (int k = 0; k < nz; ++k) {
        int c[8] = {vid(i, j, k),         vid(i + 1, j, k),
                    vid(i, j + 1, k),     vid(i + 1, j + 1, k),
                    vid(i, j, k + 1),     vid(i + 1, j, k + 1),
                    vid(i, j + 1, k + 1), vid(i + 1, j + 1, k + 1)};
        const int(*pat)[4] = ((i + j + k) % 2 == 0) ? even : odd;
        for (int t = 0; t < 5; ++t) {
          int a = c[pat[t][0]], b = c[pat[t][1]], d = c[pat[t][2]],
              e = c[pat[t][3]];
          // Ensure positive volume.
          Vec3 p0(verts[a * 3], verts[a * 3 + 1], verts[a * 3 + 2]);
          Vec3 p1(verts[b * 3], verts[b * 3 + 1], verts[b * 3 + 2]);
          Vec3 p2(verts[d * 3], verts[d * 3 + 1], verts[d * 3 + 2]);
          Vec3 p3(verts[e * 3], verts[e * 3 + 1], verts[e * 3 + 2]);
          Eigen::Matrix3d E;
          E.col(0) = p1 - p0;
          E.col(1) = p2 - p0;
          E.col(2) = p3 - p0;
          if (E.determinant() < 0) std::swap(b, d);
          tets.push_back(a);
          tets.push_back(b);
          tets.push_back(d);
          tets.push_back(e);
        }
      }
}

// Solid torus: n_sec^2 cross-section grid mapped square->disk (max-norm),
// swept around the ring in n_ring wrapping segments of hexes, 5 tets each
// — matches admm_elastic_tpu.geometry.factory.make_tet_torus (an
// IRREGULAR mesh for the solver: the ring wrap breaks the lattice
// stencil, so this system's build runs its gather path here).
static void make_torus(int n_ring, int n_sec, std::vector<double>& verts,
                       std::vector<int>& tets) {
  if (n_ring % 2 != 0) n_ring += 1;
  const double major = 1.0, minor = 0.35;
  int m = n_sec;
  int n_cs = (m + 1) * (m + 1);
  std::vector<double> disk(2 * n_cs);
  for (int i = 0; i <= m; ++i)
    for (int j = 0; j <= m; ++j) {
      double v = -1.0 + 2.0 * i / m, w = -1.0 + 2.0 * j / m;
      double linf = std::max(std::fabs(v), std::fabs(w));
      double l2 = std::sqrt(v * v + w * w);
      double s = l2 > 1e-12 ? linf / l2 : 0.0;
      disk[(i * (m + 1) + j) * 2] = v * s * minor;
      disk[(i * (m + 1) + j) * 2 + 1] = w * s * minor;
    }
  for (int s = 0; s < n_ring; ++s) {
    double a = 2.0 * M_PI * s / n_ring;
    double ca = std::cos(a), sa = std::sin(a);
    for (int c = 0; c < n_cs; ++c) {
      double r = major + disk[c * 2];
      verts.push_back(r * ca);
      verts.push_back(disk[c * 2 + 1]);
      verts.push_back(r * sa);
    }
  }
  auto vid = [&](int s, int i, int j) {
    return (s % n_ring) * n_cs + i * (m + 1) + j;
  };
  const int even[5][4] = {{0, 1, 3, 5}, {0, 3, 2, 6}, {0, 5, 4, 6},
                          {3, 5, 6, 7}, {0, 3, 5, 6}};
  const int odd[5][4] = {{1, 2, 0, 4}, {1, 7, 3, 2}, {1, 4, 5, 7},
                         {2, 4, 6, 7}, {1, 2, 7, 4}};
  for (int s = 0; s < n_ring; ++s)
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < m; ++j) {
        int c[8] = {vid(s, i, j),         vid(s + 1, i, j),
                    vid(s, i + 1, j),     vid(s + 1, i + 1, j),
                    vid(s, i, j + 1),     vid(s + 1, i, j + 1),
                    vid(s, i + 1, j + 1), vid(s + 1, i + 1, j + 1)};
        const int(*pat)[4] = ((s + i + j) % 2 == 0) ? even : odd;
        for (int t = 0; t < 5; ++t) {
          int a = c[pat[t][0]], b = c[pat[t][1]], d = c[pat[t][2]],
              e = c[pat[t][3]];
          Vec3 p0(verts[a * 3], verts[a * 3 + 1], verts[a * 3 + 2]);
          Vec3 p1(verts[b * 3], verts[b * 3 + 1], verts[b * 3 + 2]);
          Vec3 p2(verts[d * 3], verts[d * 3 + 1], verts[d * 3 + 2]);
          Vec3 p3(verts[e * 3], verts[e * 3 + 1], verts[e * 3 + 2]);
          Eigen::Matrix3d E;
          E.col(0) = p1 - p0;
          E.col(1) = p2 - p0;
          E.col(2) = p3 - p0;
          if (E.determinant() < 0) std::swap(b, d);
          tets.push_back(a);
          tets.push_back(b);
          tets.push_back(d);
          tets.push_back(e);
        }
      }
}

// TetGen-format loader (model 7): <base>.node + <base>.ele, the
// reference's own sample data files verbatim. Orientation normalized
// exactly like admm_elastic_tpu.geometry.io.load_elenode (swap columns
// 1,2 of negative-volume tets) so both builds simulate the same mesh.
static void load_elenode(const char* base, std::vector<double>& verts,
                         std::vector<int>& tets) {
  std::ifstream nf((std::string(base) + ".node").c_str());
  int n_pts = 0, dim = 0, na = 0, nb = 0;
  nf >> n_pts >> dim >> na >> nb;
  verts.resize((size_t)n_pts * 3);
  long first_idx = 0;
  for (int i = 0; i < n_pts; ++i) {
    long id = 0;
    double x, y, z;
    nf >> id >> x >> y >> z;
    if (i == 0) first_idx = id;
    verts[i * 3] = x;
    verts[i * 3 + 1] = y;
    verts[i * 3 + 2] = z;
  }
  std::ifstream ef((std::string(base) + ".ele").c_str());
  int n_t = 0, npt = 0, attr = 0;
  ef >> n_t >> npt >> attr;
  tets.resize((size_t)n_t * 4);
  for (int t = 0; t < n_t; ++t) {
    long id, a, b, c, d;
    ef >> id >> a >> b >> c >> d;
    tets[t * 4] = (int)(a - first_idx);
    tets[t * 4 + 1] = (int)(b - first_idx);
    tets[t * 4 + 2] = (int)(c - first_idx);
    tets[t * 4 + 3] = (int)(d - first_idx);
  }
  for (int t = 0; t < n_t; ++t) {
    Eigen::Vector3d p[4];
    for (int j = 0; j < 4; ++j)
      p[j] = Eigen::Vector3d(verts[tets[t * 4 + j] * 3],
                             verts[tets[t * 4 + j] * 3 + 1],
                             verts[tets[t * 4 + j] * 3 + 2]);
    Eigen::Matrix3d E;
    E.col(0) = p[1] - p[0];
    E.col(1) = p[2] - p[0];
    E.col(2) = p[3] - p[0];
    if (E.determinant() < 0) std::swap(tets[t * 4 + 1], tets[t * 4 + 2]);
  }
}

int main(int argc, char** argv) {
  int nx = 40, ny = 5, nz = 5, iters = 10, n_steps = 20, model = 1;
  if (argc > 3) {
    nx = atoi(argv[1]);
    ny = atoi(argv[2]);
    nz = atoi(argv[3]);
  }
  if (argc > 4) iters = atoi(argv[4]);
  if (argc > 5) n_steps = atoi(argv[5]);
  if (argc > 6) model = atoi(argv[6]);
  const char* dumpfile = (argc > 7) ? argv[7] : nullptr;
  int linsolver = (argc > 8) ? atoi(argv[8]) : 0;
  bool with_floor = (argc > 9) && atof(argv[9]) != 9999.0;
  double floor_y = with_floor ? atof(argv[9]) : 0.0;
  // Optional hard strain limits for the cloth scene (model 3).
  double limit_min = (argc > 10) ? atof(argv[10]) : -100.0;
  double limit_max = (argc > 11) ? atof(argv[11]) : 100.0;
  // Optional wind vector (model 3): argv 12..14; optional gravity argv 15.
  bool with_wind = (argc > 14);
  double gravity = (argc > 15) ? atof(argv[15]) : -9.8;

  admm::Solver solver;
  std::vector<double> verts;
  std::vector<int> tets;
  std::vector<int> tris;
  if (model == 4) {
    // Self-collision boxes scene (tvcg2017 boxes.cpp class): two nx-res
    // unit boxes stacked 1.25 apart over a floor, NCMCGS, TetMeshCollision
    // per box with surface inds — the reference's dynamic-collision path.
    // Mirrors tests/test_contact.py::test_boxes_stack_gs for ours-vs-ref.
    int n = nx;
    double cell = 1.0 / n;
    std::vector<std::shared_ptr<mcl::TetMesh>> boxes;
    for (int b = 0; b < 2; ++b) {
      std::vector<double> bv;
      std::vector<int> bt;
      make_beam(n, n, n, bv, bt);
      auto mesh = mcl::TetMesh::create();
      int v_off = static_cast<int>(verts.size()) / 3;
      for (size_t v = 0; v < bv.size() / 3; ++v) {
        double px = bv[v * 3] * cell;
        double py = bv[v * 3 + 1] * cell + b * 1.25;
        double pz = bv[v * 3 + 2] * cell;
        verts.push_back(px);
        verts.push_back(py);
        verts.push_back(pz);
        mesh->vertices.push_back(mcl::Vec3f((float)px, (float)py, (float)pz));
      }
      for (size_t t = 0; t < bt.size() / 4; ++t) {
        mesh->tets.push_back(mcl::Vec4i(bt[t * 4], bt[t * 4 + 1],
                                        bt[t * 4 + 2], bt[t * 4 + 3]));
        for (int j = 0; j < 4; ++j) tets.push_back(bt[t * 4 + j] + v_off);
      }
      mesh->need_faces();
      std::vector<int> sinds;
      mesh->surface_inds(sinds);
      for (int si : sinds) solver.surface_inds.push_back(si + v_off);
      solver.add_dynamic_collider(
          std::make_shared<admm::TetMeshCollision>(mesh, v_off));
      boxes.push_back(mesh);
    }
  } else if (model == 3) {
    // Triangle sheet in the xz plane, matching
    // admm_elastic_tpu.geometry.factory.make_plane(nx, ny, size=nx).
    auto vid = [&](int i, int j) { return i * (ny + 1) + j; };
    for (int i = 0; i <= nx; ++i)
      for (int j = 0; j <= ny; ++j) {
        verts.push_back(i);
        verts.push_back(0.0);
        verts.push_back(j * (double)nx / ny);
      }
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < ny; ++j) {
        tris.push_back(vid(i, j));
        tris.push_back(vid(i + 1, j));
        tris.push_back(vid(i, j + 1));
        tris.push_back(vid(i + 1, j));
        tris.push_back(vid(i + 1, j + 1));
        tris.push_back(vid(i, j + 1));
      }
  } else if (model == 5) {
    // Mesh-obstacle accuracy scene: a unit soft cube dropped onto a
    // tet-meshed slab through the reference's exact BVH PassiveMesh path
    // (PassiveObject.hpp:67-107: point-in-tet test + nearest-surface-
    // triangle projection). This system runs the same scene through its
    // voxel-SDF PassiveMeshSDF at several resolutions to quantify the
    // redesign's accuracy envelope (tests/test_parity.py).
    make_beam(nx, ny, nz, verts, tets);
    double cell = 1.0 / nx;
    for (size_t v = 0; v < verts.size() / 3; ++v) {
      verts[v * 3] *= cell;
      verts[v * 3 + 1] = verts[v * 3 + 1] * cell + 0.4;
      verts[v * 3 + 2] *= cell;
    }
  } else if (model == 6) {
    // Solid torus (irregular for the solver: the ring wrap): nx = n_ring,
    // ny = n_sec. Pins: the s=0 cross-section ring (first (ny+1)^2 verts).
    make_torus(nx, ny, verts, tets);
  } else if (model == 7) {
    // Real sample mesh via REF_ELENODE=<base> (e.g. the upstream
    // bunny_1124) — NeoHookean tets, bottom band pinned below.
    const char* base = getenv("REF_ELENODE");
    if (!base) {
      fprintf(stderr, "model 7 requires REF_ELENODE=<basename>\n");
      return 1;
    }
    load_elenode(base, verts, tets);
  } else {
    make_beam(nx, ny, nz, verts, tets);
  }
  int n_verts = static_cast<int>(verts.size()) / 3;
  int n_tets = static_cast<int>(tets.size()) / 4;
  int n_tris = static_cast<int>(tris.size()) / 3;

  admm::Solver::Settings settings;
  settings.verbose = 0;
  settings.admm_iters = iters;
  settings.linsolver = linsolver;
  settings.gravity = gravity;

  // Lumped masses at rubber density (1522, AddMeshes.hpp:105); cloth uses
  // area-weighted lumping like add_trimesh.
  std::vector<double> masses(n_verts * 3, 0.0);
  for (int t = 0; t < n_tris; ++t) {
    Vec3 p0(verts[tris[t * 3] * 3], verts[tris[t * 3] * 3 + 1], verts[tris[t * 3] * 3 + 2]);
    Vec3 p1(verts[tris[t * 3 + 1] * 3], verts[tris[t * 3 + 1] * 3 + 1], verts[tris[t * 3 + 1] * 3 + 2]);
    Vec3 p2(verts[tris[t * 3 + 2] * 3], verts[tris[t * 3 + 2] * 3 + 1], verts[tris[t * 3 + 2] * 3 + 2]);
    double area = 0.5 * ((p1 - p0).cross(p2 - p0)).norm();
    for (int j = 0; j < 3; ++j)
      for (int sdim = 0; sdim < 3; ++sdim)
        masses[tris[t * 3 + j] * 3 + sdim] += 1522.0 * area / 3.0;
  }
  for (int t = 0; t < n_tets; ++t) {
    Vec3 p[4];
    for (int j = 0; j < 4; ++j)
      p[j] = Vec3(verts[tets[t * 4 + j] * 3], verts[tets[t * 4 + j] * 3 + 1],
                  verts[tets[t * 4 + j] * 3 + 2]);
    Eigen::Matrix3d E;
    E.col(0) = p[1] - p[0];
    E.col(1) = p[2] - p[0];
    E.col(2) = p[3] - p[0];
    double vol = E.determinant() / 6.0;
    for (int j = 0; j < 4; ++j) {
      double m = 1522.0 * vol / 4.0;
      for (int s = 0; s < 3; ++s) masses[tets[t * 4 + j] * 3 + s] += m;
    }
  }
  solver.add_nodes<double>(verts.data(), masses.data(), n_verts);

  admm::Lame soft_rubber(10000000, 0.399);
  soft_rubber.limit_min = limit_min;
  soft_rubber.limit_max = limit_max;
  if (model == 4) {
    // boxes.cpp uses LINEAR tets at Lame::rubber() (boxes.cpp:39,51).
    admm::Lame rubber(10000000, 0.499);
    admm::create_tets_from_mesh<double, admm::TetEnergyTerm>(
        solver.energyterms, verts.data(), tets.data(), n_tets, rubber, 0);
  } else if (model == 3) {
    admm::create_tris_from_mesh<double, admm::TriEnergyTerm>(
        solver.energyterms, verts.data(), tris.data(), n_tris, soft_rubber, 0);
  } else if (model == 0 || model == 5) {
    admm::create_tets_from_mesh<double, admm::TetEnergyTerm>(
        solver.energyterms, verts.data(), tets.data(), n_tets, soft_rubber, 0);
  } else if (model == 2) {
    admm::create_tets_from_mesh<double, admm::StVKTet>(
        solver.energyterms, verts.data(), tets.data(), n_tets, soft_rubber, 0);
  } else {
    admm::create_tets_from_mesh<double, admm::NeoHookeanTet>(
        solver.energyterms, verts.data(), tets.data(), n_tets, soft_rubber, 0);
  }

  if (model == 5) {
    // Slab obstacle: make_beam(6,2,6) at cell 0.25, translated so the
    // top face is y = -0.1 and the footprint covers the falling cube
    // (x,z in [-0.25, 1.25]). Identical geometry is rebuilt python-side
    // for the voxel-SDF comparison.
    std::vector<double> ov;
    std::vector<int> ot;
    make_beam(6, 2, 6, ov, ot);
    auto omesh = mcl::TetMesh::create();
    for (size_t v = 0; v < ov.size() / 3; ++v)
      omesh->vertices.push_back(
          mcl::Vec3f((float)(ov[v * 3] * 0.25 - 0.25),
                     (float)(ov[v * 3 + 1] * 0.25 - 0.6),
                     (float)(ov[v * 3 + 2] * 0.25 - 0.25)));
    for (size_t t = 0; t < ot.size() / 4; ++t)
      omesh->tets.push_back(
          mcl::Vec4i(ot[t * 4], ot[t * 4 + 1], ot[t * 4 + 2], ot[t * 4 + 3]));
    omesh->need_faces();
    solver.add_obstacle(std::make_shared<admm::PassiveMesh>(omesh));
  } else if (with_floor) {
    solver.add_obstacle(
        std::make_shared<admm::Floor>(admm::Floor(floor_y)));
  } else if (model == 6) {
    std::vector<int> pins;
    for (int v = 0; v < (ny + 1) * (ny + 1); ++v) pins.push_back(v);
    solver.set_pins(pins);
  } else if (model == 7) {
    // Pin the bottom band (the bunny's feet), matching this system's
    // scene (tests/test_parity.py / benchmarks/crossval.py kind=bunny).
    double ylo = 1e300;
    for (int v = 0; v < n_verts; ++v) ylo = std::min(ylo, verts[v * 3 + 1]);
    std::vector<int> pins;
    for (int v = 0; v < n_verts; ++v)
      if (verts[v * 3 + 1] < ylo + 0.015) pins.push_back(v);
    solver.set_pins(pins);
  } else {
    // Pin the -x face (beam) / -x edge (cloth) in place.
    std::vector<int> pins;
    for (int v = 0; v < n_verts; ++v)
      if (verts[v * 3] < 1e-9) pins.push_back(v);
    solver.set_pins(pins);
  }

  if (with_wind && model == 3) {
    std::vector<int> wind_tris(tris);
    auto wf = std::make_shared<admm::WindForce>(wind_tris);
    wf->direction = Vec3(atof(argv[12]), atof(argv[13]), atof(argv[14]));
    solver.ext_forces.push_back(wf);
  }

  mcl::MicroTimer t;
  if (!solver.initialize(settings)) {
    fprintf(stderr, "init failed\n");
    return 1;
  }
  double init_ms = t.elapsed_ms();

  // Inversion-recovery probe (bunnyexpand.cpp class, set_vertices rand
  // mode): REF_SCRAMBLE=1 scrambles every vertex uniformly inside the
  // rest bounding box after initialize, then the normal stepping below
  // runs; the JSON gains "inverted_tets" counted at the end.
  bool scrambled = std::getenv("REF_SCRAMBLE") != nullptr;
  if (scrambled) {
    srand(100);
    double lo[3] = {1e30, 1e30, 1e30}, hi[3] = {-1e30, -1e30, -1e30};
    for (int v = 0; v < n_verts; ++v)
      for (int s = 0; s < 3; ++s) {
        lo[s] = std::min(lo[s], solver.m_x[v * 3 + s]);
        hi[s] = std::max(hi[s], solver.m_x[v * 3 + s]);
      }
    for (int v = 0; v < n_verts; ++v)
      for (int s = 0; s < 3; ++s)
        solver.m_x[v * 3 + s] =
            lo[s] + (hi[s] - lo[s]) * (rand() / (double)RAND_MAX);
  }

  FILE* dump = nullptr;
  if (dumpfile) {
    dump = fopen(dumpfile, "wb");
  } else {
    // Warmup only for timing runs (keeps dumped trajectories aligned with
    // this system's build, which dumps from step 0).
    solver.step();
  }

  t.reset();
  for (int s = 0; s < n_steps; ++s) {
    solver.step();
    if (dump)
      fwrite(solver.m_x.data(), sizeof(double), solver.m_x.size(), dump);
  }
  double sim_s = t.elapsed_s();
  if (dump) fclose(dump);

  double checksum = 0.0;
  for (int i = 0; i < solver.m_x.size(); ++i) checksum += solver.m_x[i];

  int inverted = 0;
  bool finite = true;
  for (int i = 0; i < solver.m_x.size(); ++i)
    if (!std::isfinite(solver.m_x[i])) finite = false;
  for (int tt = 0; tt < n_tets; ++tt) {
    Vec3 p[4];
    for (int j = 0; j < 4; ++j)
      for (int s = 0; s < 3; ++s) p[j][s] = solver.m_x[tets[tt * 4 + j] * 3 + s];
    Eigen::Matrix3d E;
    E.col(0) = p[1] - p[0];
    E.col(1) = p[2] - p[0];
    E.col(2) = p[3] - p[0];
    if (!(E.determinant() > 0.0)) ++inverted;  // NaN counts as inverted
  }
  if (scrambled)
    fprintf(stderr, "scramble: inverted %d / %d, finite %d\n", inverted,
            n_tets, (int)finite);

  printf(
      "{\"scene\": \"beam\", \"model\": %d, \"n_verts\": %d, \"n_tets\": %d, "
      "\"admm_iters\": %d, \"n_steps\": %d, \"init_ms\": %.1f, "
      "\"sim_s\": %.4f, \"steps_per_s\": %.4f, \"admm_iters_per_s\": %.2f, "
      "\"checksum\": %.8e, \"threads\": %d}\n",
      model, n_verts, n_tets, iters, n_steps, init_ms, sim_s, n_steps / sim_s,
      n_steps * iters / sim_s, checksum, omp_get_max_threads());
  return 0;
}
