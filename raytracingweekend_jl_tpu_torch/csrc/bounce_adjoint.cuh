// The hand-written adjoint of one recorded bounce, shared by the replay
// kernels K5 and K6 (persist_replay.cu) and K7b and K7c (replay_bwd.cu).
//
// Replaces raytracingweekend_jl_tpu/ops/pallas/grad_kernel.py ::
// _bounce_adjoint, the value-level adjoint every TPU replay kernel calls. The
// plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/grad_kernel.py::bounce_adjoint,
// written expression for expression like this file (no FMA contraction on
// either side).
//
// It recomputes the bounce's forward intermediates from the record (the
// shade core's math) and transposes the shade plus the masked state advance:
// the carried (origin, direction, throughput) cotangent goes back through
// the chosen material's scatter direction, the facing normal and the hit
// point, and the hit distance is differentiated implicitly at the recorded
// winner (dt/do = -p/(p.d), dt/dd = -t p/(p.d), dt/dc = p/(p.d),
// dt/dr = r/(p.d) with p = o + t d - c). Discrete events (winner, material,
// Schlick coin, front face) are constants.
//
// It comes in two halves: rtw_adjoint_forward recomputes the intermediates
// (no carry needed), rtw_adjoint_reverse transposes with the carry.
// rtw_bounce_adjoint runs the two in turn; K7c's staged walk runs the
// forward halves of a lane's next slots on other threads. Either way the
// same operations are evaluated, so the bits are the same.

#pragma once

#include "shade_core.cuh"

// The bounce's forward intermediates that its adjoint reads: the shade
// core's math recomputed from the record and the uniforms. They do not
// depend on the carried cotangent, so a walk can compute the next slot's
// while it transposes this one.
struct RtwAdjFwd {
  float ts, px, py, pz, inv_r, nox, noy, noz, sgn, nx, ny, nz, ux, uy, uz;
  float lno, lamx, lamy, lamz, dn, mno, metx, mety, metz;
  float safe_ir, eta, ct, rpx, rpy, rpz, S, par, fno, frx, fry, frz;
  bool front, degen, choose_ref, is_lam, is_met, is_diel;
};

// u: 5 uniforms. r: the record's o3 d3 T3 t. a: the winner's 10 attributes.
// hitm: the state advanced (hit and continued).
__device__ __forceinline__ RtwAdjFwd rtw_adjoint_forward(const float* u,
                                                         const float* r,
                                                         const float* a,
                                                         bool hitm) {
  const float ox = r[0], oy = r[1], oz = r[2], dx = r[3], dy = r[4],
              dz = r[5], t = r[9];
  const float acx = a[0], acy = a[1], acz = a[2], arr = a[3], afz = a[7],
              air = a[8], amt = a[9];

  // ---- recompute forward intermediates (mirror of the shade core) ----
  const float ts = hitm ? t : 1.0f;
  const float px = ox + ts * dx, py = oy + ts * dy, pz = oz + ts * dz;
  const float inv_r = arr == 0.0f ? 0.0f : 1.0f / arr;
  const float nox = (px - acx) * inv_r, noy = (py - acy) * inv_r,
              noz = (pz - acz) * inv_r;
  const float ddn = dx * nox + dy * noy + dz * noz;
  const bool front = ddn < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  const float nx = nox * sgn, ny = noy * sgn, nz = noz * sgn;
  float g0, g1, g2;
  rtw_gauss3(u[0], u[1], u[2], u[3], g0, g1, g2);
  const float gnorm = rtw_inv_length(g0 * g0 + g1 * g1 + g2 * g2);
  const float ux = g0 * gnorm, uy = g1 * gnorm, uz = g2 * gnorm;
  const float xi = u[4];
  // lambert
  const float lx = nx + ux, ly = ny + uy, lz = nz + uz;
  const float lsq = lx * lx + ly * ly + lz * lz;
  const bool degen = lsq < 1e-5f;
  const float lno = rtw_inv_length(lsq);
  const float lamx = degen ? nx : lx * lno;
  const float lamy = degen ? ny : ly * lno;
  const float lamz = degen ? nz : lz * lno;
  // metal
  const float dn = dx * nx + dy * ny + dz * nz;
  const float mxv = (dx - 2.0f * dn * nx) + afz * ux;
  const float myv = (dy - 2.0f * dn * ny) + afz * uy;
  const float mzv = (dz - 2.0f * dn * nz) + afz * uz;
  const float mno = rtw_inv_length(mxv * mxv + myv * myv + mzv * mzv);
  const float metx = mxv * mno, mety = myv * mno, metz = mzv * mno;
  // dielectric
  const float safe_ir = air == 0.0f ? 1.0f : air;
  const float eta = front ? 1.0f / safe_ir : safe_ir;
  const float ct = fminf(-dn, 1.0f);
  const float sin_t = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const bool cannot = eta * sin_t > 1.0f;
  float r0 = (1.0f - eta) / (1.0f + eta);
  r0 = r0 * r0;
  const float omc = 1.0f - ct;
  const float omc2 = omc * omc;
  const float schlick = r0 + (1.0f - r0) * omc2 * omc2 * omc;
  const bool choose_ref = cannot || (schlick > xi);
  const float rpx = eta * (dx + ct * nx);
  const float rpy = eta * (dy + ct * ny);
  const float rpz = eta * (dz + ct * nz);
  const float S = 1.0f - (rpx * rpx + rpy * rpy + rpz * rpz);
  const float par = -sqrtf(fabsf(S));
  const float fx = rpx + par * nx, fy = rpy + par * ny, fz_ = rpz + par * nz;
  const float fno = rtw_inv_length(fx * fx + fy * fy + fz_ * fz_);
  const float frx = fx * fno, fry = fy * fno, frz = fz_ * fno;
  const bool is_lam = amt == 0.0f, is_met = amt == 1.0f;
  const bool is_diel = !is_lam && !is_met;

  RtwAdjFwd f;
  f.ts = ts;
  f.px = px;
  f.py = py;
  f.pz = pz;
  f.inv_r = inv_r;
  f.nox = nox;
  f.noy = noy;
  f.noz = noz;
  f.sgn = sgn;
  f.nx = nx;
  f.ny = ny;
  f.nz = nz;
  f.ux = ux;
  f.uy = uy;
  f.uz = uz;
  f.lno = lno;
  f.lamx = lamx;
  f.lamy = lamy;
  f.lamz = lamz;
  f.dn = dn;
  f.mno = mno;
  f.metx = metx;
  f.mety = mety;
  f.metz = metz;
  f.safe_ir = safe_ir;
  f.eta = eta;
  f.ct = ct;
  f.rpx = rpx;
  f.rpy = rpy;
  f.rpz = rpz;
  f.S = S;
  f.par = par;
  f.fno = fno;
  f.frx = frx;
  f.fry = fry;
  f.frz = frz;
  f.front = front;
  f.degen = degen;
  f.choose_ref = choose_ref;
  f.is_lam = is_lam;
  f.is_met = is_met;
  f.is_diel = is_diel;
  return f;
}

// The adjoint of one recorded bounce given its forward intermediates f
// (rtw_adjoint_forward of the same u, r, a and hitm). r, a: as there. g: the
// radiance cotangent of the lane's strip. cot: the carried cotangent of this
// bounce's outputs, replaced by that of its inputs. hitm: the state advanced
// (hit and continued); missm: the bounce banked T * sky(d). dattr:
// cotangent rows for center xyz, radius, albedo rgb, fuzz, ir.
__device__ __forceinline__ void rtw_adjoint_reverse(
    const RtwAdjFwd& f, const float* r, const float* a, const float* g,
    float* cot, bool hitm, bool missm, float* dattr) {
  const float dx = r[3], dy = r[4], dz = r[5], Tx = r[6], Ty = r[7],
              Tz = r[8];
  const float acx = a[0], acy = a[1], acz = a[2], arr = a[3], aar = a[4],
              aag = a[5], aab = a[6];
  const float grx = g[0], gry = g[1], grz = g[2];
  const float gox_ = cot[0], goy_ = cot[1], goz_ = cot[2], gdx_ = cot[3],
              gdy_ = cot[4], gdz_ = cot[5], gTx_ = cot[6], gTy_ = cot[7],
              gTz_ = cot[8];
  const float hf = hitm ? 1.0f : 0.0f;
  const float mf = missm ? 1.0f : 0.0f;
  const float ts = f.ts;
  const float px = f.px;
  const float py = f.py;
  const float pz = f.pz;
  const float inv_r = f.inv_r;
  const float nox = f.nox;
  const float noy = f.noy;
  const float noz = f.noz;
  const float sgn = f.sgn;
  const float nx = f.nx;
  const float ny = f.ny;
  const float nz = f.nz;
  const float ux = f.ux;
  const float uy = f.uy;
  const float uz = f.uz;
  const float lno = f.lno;
  const float lamx = f.lamx;
  const float lamy = f.lamy;
  const float lamz = f.lamz;
  const float dn = f.dn;
  const float mno = f.mno;
  const float metx = f.metx;
  const float mety = f.mety;
  const float metz = f.metz;
  const float safe_ir = f.safe_ir;
  const float eta = f.eta;
  const float ct = f.ct;
  const float rpx = f.rpx;
  const float rpy = f.rpy;
  const float rpz = f.rpz;
  const float S = f.S;
  const float par = f.par;
  const float fno = f.fno;
  const float frx = f.frx;
  const float fry = f.fry;
  const float frz = f.frz;
  const bool front = f.front;
  const bool degen = f.degen;
  const bool choose_ref = f.choose_ref;
  const bool is_lam = f.is_lam;
  const bool is_met = f.is_met;
  const bool is_diel = f.is_diel;

  // ---- adjoint ----
  const float nhf = 1.0f - hf;
  // o' = hitm ? p : o ; d' = hitm ? nd : d ; T' = hitm ? T*A : T
  float gpx = hf * gox_, gpy = hf * goy_, gpz = hf * goz_;
  float go_x = nhf * gox_, go_y = nhf * goy_, go_z = nhf * goz_;
  const float gndx = hf * gdx_, gndy = hf * gdy_, gndz = hf * gdz_;
  float gd_x = nhf * gdx_, gd_y = nhf * gdy_, gd_z = nhf * gdz_;
  float gTx = gTx_ * (hitm ? aar : 1.0f);
  float gTy = gTy_ * (hitm ? aag : 1.0f);
  float gTz = gTz_ * (hitm ? aab : 1.0f);
  const float gA_r = hf * gTx_ * Tx, gA_g = hf * gTy_ * Ty,
              gA_b = hf * gTz_ * Tz;
  // miss lanes banked rad += T * sky(d); sky = (1-0.5s, 1-0.3s, 1), s=0.5(dy+1)
  const float sth = 0.5f * (dy + 1.0f);
  gTx = gTx + mf * grx * (1.0f - 0.5f * sth);
  gTy = gTy + mf * gry * (1.0f - 0.3f * sth);
  gTz = gTz + mf * grz;
  const float g_sth = mf * (grx * Tx * (-0.5f) + gry * Ty * (-0.3f));
  gd_y = gd_y + 0.5f * g_sth;

  // route the nd cotangent to the selected material branch
  const float lamf = is_lam ? 1.0f : 0.0f;
  const float metf = is_met ? 1.0f : 0.0f;
  const float dief = is_diel ? 1.0f : 0.0f;
  const float glx_r = lamf * gndx, gly_r = lamf * gndy, glz_r = lamf * gndz;
  const float gmx_r = metf * gndx, gmy_r = metf * gndy, gmz_r = metf * gndz;
  const float gqx = dief * gndx, gqy = dief * gndy, gqz = dief * gndz;

  // lambert: lam = degen ? n : l * lno (u constant)
  const float dotl = lamx * glx_r + lamy * gly_r + lamz * glz_r;
  const float ndegf = 1.0f - (degen ? 1.0f : 0.0f);
  const float glx = ndegf * lno * (glx_r - lamx * dotl);
  const float gly = ndegf * lno * (gly_r - lamy * dotl);
  const float glz = ndegf * lno * (glz_r - lamz * dotl);
  const float degf = degen ? 1.0f : 0.0f;
  float gn_x = glx + degf * glx_r;
  float gn_y = gly + degf * gly_r;
  float gn_z = glz + degf * glz_r;

  // metal: met = m * mno; m = refl + fz * u
  const float dotm = metx * gmx_r + mety * gmy_r + metz * gmz_r;
  const float gmx = mno * (gmx_r - metx * dotm);
  const float gmy = mno * (gmy_r - mety * dotm);
  const float gmz = mno * (gmz_r - metz * dotm);
  const float gfz = ux * gmx + uy * gmy + uz * gmz;
  float grefl_x = gmx, grefl_y = gmy, grefl_z = gmz;

  // dielectric select (coin/TIR detached)
  const float crf = choose_ref ? 1.0f : 0.0f;
  grefl_x = grefl_x + crf * gqx;
  grefl_y = grefl_y + crf * gqy;
  grefl_z = grefl_z + crf * gqz;
  const float ncrf = 1.0f - crf;
  const float gfr_x = ncrf * gqx, gfr_y = ncrf * gqy, gfr_z = ncrf * gqz;
  // fr = f * fno
  const float dotf = frx * gfr_x + fry * gfr_y + frz * gfr_z;
  const float gf_x = fno * (gfr_x - frx * dotf);
  const float gf_y = fno * (gfr_y - fry * dotf);
  const float gf_z = fno * (gfr_z - frz * dotf);
  // f = rp + par * n
  float grp_x = gf_x, grp_y = gf_y, grp_z = gf_z;
  const float gpar = nx * gf_x + ny * gf_y + nz * gf_z;
  gn_x = gn_x + par * gf_x;
  gn_y = gn_y + par * gf_y;
  gn_z = gn_z + par * gf_z;
  // par = -sqrt(|S|)
  const float sgnS = S >= 0.0f ? 1.0f : -1.0f;
  const float gS =
      gpar * (-sgnS * 0.5f * rtw_inv_length(fmaxf(fabsf(S), 1e-12f)));
  // S = 1 - rp.rp
  grp_x = grp_x - 2.0f * rpx * gS;
  grp_y = grp_y - 2.0f * rpy * gS;
  grp_z = grp_z - 2.0f * rpz * gS;
  // rp = eta * (d + ct * n)
  const float geta = ((dx + ct * nx) * grp_x + (dy + ct * ny) * grp_y
                      + (dz + ct * nz) * grp_z);
  gd_x = gd_x + eta * grp_x;
  gd_y = gd_y + eta * grp_y;
  gd_z = gd_z + eta * grp_z;
  const float gct = eta * (nx * grp_x + ny * grp_y + nz * grp_z);
  gn_x = gn_x + eta * ct * grp_x;
  gn_y = gn_y + eta * ct * grp_y;
  gn_z = gn_z + eta * ct * grp_z;
  // ct = min(-dn, 1): pass-through where -dn < 1
  float gdn = -dn < 1.0f ? -gct : 0.0f;
  // eta = front ? 1/safe_ir : safe_ir
  const float gir = front ? -geta / (safe_ir * safe_ir) : geta;
  // refl = d - 2 dn n (metal + diel-reflect)
  gdn = gdn - 2.0f * (nx * grefl_x + ny * grefl_y + nz * grefl_z);
  gn_x = gn_x - 2.0f * dn * grefl_x;
  gn_y = gn_y - 2.0f * dn * grefl_y;
  gn_z = gn_z - 2.0f * dn * grefl_z;
  gd_x = gd_x + grefl_x;
  gd_y = gd_y + grefl_y;
  gd_z = gd_z + grefl_z;
  // dn = d . n
  gd_x = gd_x + gdn * nx;
  gd_y = gd_y + gdn * ny;
  gd_z = gd_z + gdn * nz;
  gn_x = gn_x + gdn * dx;
  gn_y = gn_y + gdn * dy;
  gn_z = gn_z + gdn * dz;
  // n = sgn * n_out; n_out = (p - c) * inv_r
  const float gno_x = sgn * gn_x, gno_y = sgn * gn_y, gno_z = sgn * gn_z;
  gpx = gpx + gno_x * inv_r;
  gpy = gpy + gno_y * inv_r;
  gpz = gpz + gno_z * inv_r;
  float gc_x = -gno_x * inv_r;
  float gc_y = -gno_y * inv_r;
  float gc_z = -gno_z * inv_r;
  float gr = -(nox * gno_x + noy * gno_y + noz * gno_z) * inv_r;
  // p = o + ts d
  go_x = go_x + gpx;
  go_y = go_y + gpy;
  go_z = go_z + gpz;
  gd_x = gd_x + ts * gpx;
  gd_y = gd_y + ts * gpy;
  gd_z = gd_z + ts * gpz;
  const float gt = dx * gpx + dy * gpy + dz * gpz;
  // implicit hit distance at the recorded winner
  const float psx = px - acx, psy = py - acy, psz = pz - acz;
  const float pd = psx * dx + psy * dy + psz * dz;
  const bool big_pd = fabsf(pd) > 1e-12f;
  const bool ok = hitm && big_pd;
  const float scl = ok ? gt / (big_pd ? pd : 1.0f) : 0.0f;
  go_x = go_x - scl * psx;
  go_y = go_y - scl * psy;
  go_z = go_z - scl * psz;
  gd_x = gd_x - scl * ts * psx;
  gd_y = gd_y - scl * ts * psy;
  gd_z = gd_z - scl * ts * psz;
  gc_x = gc_x + scl * psx;
  gc_y = gc_y + scl * psy;
  gc_z = gc_z + scl * psz;
  gr = gr + scl * arr;

  cot[0] = go_x; cot[1] = go_y; cot[2] = go_z;
  cot[3] = gd_x; cot[4] = gd_y; cot[5] = gd_z;
  cot[6] = gTx; cot[7] = gTy; cot[8] = gTz;
  dattr[0] = gc_x; dattr[1] = gc_y; dattr[2] = gc_z; dattr[3] = gr;
  dattr[4] = gA_r; dattr[5] = gA_g; dattr[6] = gA_b; dattr[7] = gfz;
  dattr[8] = gir;
}

// u: 5 uniforms. r: the record's o3 d3 T3 t. a: the winner's 10 attributes.
// g: the radiance cotangent of the lane's strip. cot: the carried cotangent
// of this bounce's outputs, replaced by that of its inputs. hitm: the state
// advanced (hit and continued); missm: the bounce banked T * sky(d).
// dattr: cotangent rows for center xyz, radius, albedo rgb, fuzz, ir.
__device__ __forceinline__ void rtw_bounce_adjoint(
    const float* u, const float* r, const float* a, const float* g,
    float* cot, bool hitm, bool missm, float* dattr) {
  rtw_adjoint_reverse(rtw_adjoint_forward(u, r, a, hitm), r, a, g, cot, hitm,
                      missm, dattr);
}
