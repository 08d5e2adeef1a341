"""Panel meshing for potential-flow members + HAMS/WAMIT mesh writers.

A numpy copy of ``raft_tpu/io/mesh.py`` (the port never imports the JAX
package): the same vertices and panels, bit for bit.  Equivalent of the reference's mesh sidecar (reference: raft/member2pnl.py):
axisymmetric members are revolved into quad panels with the same
discretization policy — ``dz_max`` longitudinal panel height, ``da_max``
azimuthal width with power-of-two azimuth doubling as radius grows,
waterline clipping, and radial end-cap fill (member2pnl.py:73-278) — then
written as a HAMS ``HullMesh.pnl`` (member2pnl.py:280-310) or WAMIT
``.gdf`` (member2pnl.py:496-546).

The mesh feeds the native BEM core (raft_tpu_torch/io/bem_native.py) and can be
exported for external solvers, mirroring how the reference feeds pyHAMS
(raft_fowt.py:607-650).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from raft_tpu_torch.errors import ModelConfigError


@dataclass
class PanelMesh:
    """Quad panel mesh: vertices (N,3) and panels (M,4) vertex indices.

    Triangles repeat the last index.  Panel vertex order gives outward
    normals (into the fluid) via the right-hand rule.

    ``n_body``: the first n_body panels are the wetted body surface; any
    panels after them are interior-waterplane LID panels used by the BEM
    core's irregular-frequency removal (extended boundary condition).
    Negative means all panels are body panels.
    """

    verts: np.ndarray
    panels: np.ndarray
    n_body: int = -1

    @property
    def nbody(self):
        return self.npanels if self.n_body < 0 else self.n_body

    @property
    def npanels(self):
        return len(self.panels)

    def panel_geometry(self):
        """(centroids (M,3), normals (M,3) unit OUTWARD, areas (M,)).

        Quads are split into two triangles; the normal is the area-weighted
        mean (flat-panel approximation, same as low-order BEM codes).  The
        stored vertex order replicates the reference generator's (so .pnl
        and .gdf exports are bit-compatible); its right-hand-rule normal
        points outward (into the fluid), verified on the cylinder test."""
        v = self.verts[self.panels]          # (M, 4, 3)
        a, b, c, d = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
        n1 = 0.5 * np.cross(b - a, c - a)
        n2 = 0.5 * np.cross(c - a, d - a)
        n = n1 + n2
        area = np.linalg.norm(n, axis=1)
        area1 = np.linalg.norm(n1, axis=1)
        area2 = np.linalg.norm(n2, axis=1)
        cen1 = (a + b + c) / 3.0
        cen2 = (a + c + d) / 3.0
        w = np.where(area1 + area2 > 0, area1 + area2, 1.0)[:, None]
        cen = (cen1 * area1[:, None] + cen2 * area2[:, None]) / w
        nrm = n / np.where(area > 0, area, 1.0)[:, None]
        return cen, nrm, area

    def volume_centroid(self):
        """Displaced volume and center of buoyancy by the divergence
        theorem over the wetted surface (the z=0 lid contributes zero)."""
        cen, nrm, area = self.panel_geometry()
        anz = area * nrm[:, 2]
        V = np.sum(anz * cen[:, 2])
        if V <= 0:
            return 0.0, np.zeros(3)
        rb = np.zeros(3)
        rb[0] = np.sum(anz * cen[:, 2] * cen[:, 0]) / V
        rb[1] = np.sum(anz * cen[:, 2] * cen[:, 1]) / V
        rb[2] = 0.5 * np.sum(anz * cen[:, 2] ** 2) / V
        return V, rb


class _MeshBuilder:
    """Node-deduplicating accumulator (reference: member2pnl.py:8-71)."""

    def __init__(self):
        self.nodes = []
        self.index = {}
        self.panels = []

    def add_panel(self, X, Y, Z):
        Z = np.asarray(Z, float)
        if np.all(Z > 0.0):       # fully above water: skip
            return
        Z = np.minimum(Z, 0.0)    # clip to the waterline
        ids = []
        for i in range(4):
            key = (round(float(X[i]), 6), round(float(Y[i]), 6),
                   round(float(Z[i]), 6))
            j = self.index.get(key)
            if j is None:
                j = len(self.nodes)
                self.nodes.append([key[0], key[1], key[2]])
                self.index[key] = j
            if j in ids:
                continue          # degenerate edge -> triangle
            ids.append(j)
        if len(ids) < 3:
            return                # fully degenerate panel
        if len(ids) == 3:
            ids.append(ids[-1])
        self.panels.append(ids)

    def mesh(self) -> PanelMesh:
        return PanelMesh(np.asarray(self.nodes, float),
                         np.asarray(self.panels, int))


def _radius_profile(stations, radii, dz_max, da_max):
    """Discretize the (station, radius) profile with slope-weighted panel
    sizes and radial end fills (reference: member2pnl.py:113-165)."""
    r_rp = [radii[0]]
    z_rp = [stations[0]]
    for i_s in range(1, len(radii)):
        dr_s = radii[i_s] - radii[i_s - 1]
        dz_s = stations[i_s] - stations[i_s - 1]
        if dr_s == 0:
            cos_m, sin_m, dz_ps = 1.0, 0.0, dz_max
        elif dz_s == 0:
            cos_m, sin_m, dz_ps = 0.0, np.sign(dr_s), 0.6 * da_max
        else:
            m = dr_s / dz_s
            dz_ps = (np.arctan(np.abs(m)) * 2 / np.pi * 0.6 * da_max
                     + np.arctan(abs(1 / m)) * 2 / np.pi * dz_max)
            h = np.sqrt(dr_s**2 + dz_s**2)
            cos_m, sin_m = dz_s / h, dr_s / h
        seg = np.sqrt(dr_s**2 + dz_s**2)
        n_z = max(int(np.ceil(seg / dz_ps)), 1)
        d_l = seg / n_z
        for i_z in range(1, n_z + 1):
            r_rp.append(radii[i_s - 1] + sin_m * i_z * d_l)
            z_rp.append(stations[i_s - 1] + cos_m * i_z * d_l)

    # radial fill of end B then end A (caps)
    if radii[-1] > 0:
        n_r = int(np.ceil(radii[-1] / (0.6 * da_max)))
        dr = radii[-1] / n_r
        for i_r in range(n_r):
            r_rp.append(radii[-1] - (1 + i_r) * dr)
            z_rp.append(stations[-1])
    if radii[0] > 0:
        n_r = int(np.ceil(radii[0] / (0.6 * da_max)))
        dr = radii[0] / n_r
        for i_r in range(n_r):
            r_rp.insert(0, radii[0] - (1 + i_r) * dr)
            z_rp.insert(0, stations[0])
    return r_rp, z_rp


def mesh_member(stations, diameters, rA, rB, dz_max=0.0, da_max=0.0,
                builder: _MeshBuilder = None) -> _MeshBuilder:
    """Mesh one axisymmetric member into quad panels (reference:
    member2pnl.py:73-278 meshMember).

    ``stations`` are axial positions from end A (any monotonic scale whose
    span equals the member length), ``diameters`` the matching outer
    diameters.  The revolved profile is rotated by the member incline
    (Z1Y2Z3 Euler, reference :246-259) and translated to ``rA``; panels
    fully above the waterline are dropped, straddling ones clipped.
    """
    if builder is None:
        builder = _MeshBuilder()
    stations = np.asarray(stations, float)
    radii = 0.5 * np.asarray(diameters, float)
    rA = np.asarray(rA, float)
    rB = np.asarray(rB, float)

    if dz_max == 0:
        dz_max = stations[-1] / 20
    if da_max == 0:
        da_max = np.max(radii) / 8

    r_rp, z_rp = _radius_profile(stations, radii, dz_max, da_max)

    # member orientation (reference :246-259)
    rAB = rB - rA
    beta = np.arctan2(rAB[1], rAB[0])
    phi = np.arctan2(np.sqrt(rAB[0]**2 + rAB[1]**2), rAB[2])
    s1, c1 = np.sin(beta), np.cos(beta)
    s2, c2 = np.sin(phi), np.cos(phi)
    R = np.array([[c1 * c2, -s1, c1 * s2],
                  [c2 * s1, c1, s1 * s2],
                  [-s2, 0.0, c2]])

    def emit(xs, ys, zs):
        nodes = R @ np.array([xs, ys, zs]) + rA[:, None]
        builder.add_panel(nodes[0], nodes[1], nodes[2])

    naz = 8
    for i_rp in range(len(z_rp) - 1):
        r1, r2 = r_rp[i_rp], r_rp[i_rp + 1]
        z1, z2 = z_rp[i_rp], z_rp[i_rp + 1]
        # azimuthal refinement doubling/halving (reference :186-192)
        while (r1 * 2 * np.pi / naz >= da_max / 2
               and r2 * 2 * np.pi / naz >= da_max / 2):
            naz = int(2 * naz)
        while (r1 * 2 * np.pi / naz < da_max / 2
               and r2 * 2 * np.pi / naz < da_max / 2 and naz > 8):
            naz = int(naz / 2)

        inc = (r1 * 2 * np.pi / naz < da_max / 2
               and r2 * 2 * np.pi / naz >= da_max / 2)
        dec = (r1 * 2 * np.pi / naz >= da_max / 2
               and r2 * 2 * np.pi / naz < da_max / 2)
        if inc:       # transition row: double the azimuth count on row 2
            for ia in range(1, int(naz / 2) + 1):
                th1 = (ia - 1) * 4 * np.pi / naz
                th2 = (ia - 0.5) * 4 * np.pi / naz
                th3 = ia * 4 * np.pi / naz
                emit([(r1 * np.cos(th1) + r1 * np.cos(th3)) / 2,
                      r2 * np.cos(th2), r2 * np.cos(th1), r1 * np.cos(th1)],
                     [(r1 * np.sin(th1) + r1 * np.sin(th3)) / 2,
                      r2 * np.sin(th2), r2 * np.sin(th1), r1 * np.sin(th1)],
                     [z1, z2, z2, z1])
                emit([r1 * np.cos(th3), r2 * np.cos(th3), r2 * np.cos(th2),
                      (r1 * np.cos(th1) + r1 * np.cos(th3)) / 2],
                     [r1 * np.sin(th3), r2 * np.sin(th3), r2 * np.sin(th2),
                      (r1 * np.sin(th1) + r1 * np.sin(th3)) / 2],
                     [z1, z2, z2, z1])
        elif dec:     # transition row: halve the azimuth count on row 2
            for ia in range(1, int(naz / 2) + 1):
                th1 = (ia - 1) * 4 * np.pi / naz
                th2 = (ia - 0.5) * 4 * np.pi / naz
                th3 = ia * 4 * np.pi / naz
                emit([r1 * np.cos(th2), r2 * (np.cos(th1) + np.cos(th3)) / 2,
                      r2 * np.cos(th1), r1 * np.cos(th1)],
                     [r1 * np.sin(th2), r2 * (np.sin(th1) + np.sin(th3)) / 2,
                      r2 * np.sin(th1), r1 * np.sin(th1)],
                     [z1, z2, z2, z1])
                emit([r1 * np.cos(th3), r2 * np.cos(th3),
                      r2 * (np.cos(th1) + np.cos(th3)) / 2, r1 * np.cos(th2)],
                     [r1 * np.sin(th3), r2 * np.sin(th3),
                      r2 * (np.sin(th1) + np.sin(th3)) / 2, r1 * np.sin(th2)],
                     [z1, z2, z2, z1])
        else:
            for ia in range(1, naz + 1):
                th1 = (ia - 1) * 2 * np.pi / naz
                th2 = ia * 2 * np.pi / naz
                emit([r1 * np.cos(th2), r2 * np.cos(th2), r2 * np.cos(th1),
                      r1 * np.cos(th1)],
                     [r1 * np.sin(th2), r2 * np.sin(th2), r2 * np.sin(th1),
                      r1 * np.sin(th1)],
                     [z1, z2, z2, z1])
    return builder


def lid_disk(builder: _MeshBuilder, cx, cy, R, da_max, z_lid):
    """Interior-waterplane lid panels: concentric ring quads over the disk
    of radius R centered at (cx, cy), at depth ``z_lid`` (slightly below
    z=0 so the wave-kernel tables stay in range).  Used by the BEM core's
    irregular-frequency removal — not part of the wetted body surface."""
    n_r = max(int(np.ceil(R / (0.6 * da_max))), 2)
    radii = np.linspace(R, 0.0, n_r + 1)
    naz = 8
    for i in range(n_r):
        r1, r2 = radii[i], radii[i + 1]
        while r1 * 2 * np.pi / naz >= da_max and naz < 256:
            naz *= 2
        for ia in range(naz):
            th1 = ia * 2 * np.pi / naz
            th2 = (ia + 1) * 2 * np.pi / naz
            builder.add_panel(
                [cx + r1 * np.cos(th2), cx + r2 * np.cos(th2),
                 cx + r2 * np.cos(th1), cx + r1 * np.cos(th1)],
                [cy + r1 * np.sin(th2), cy + r2 * np.sin(th2),
                 cy + r2 * np.sin(th1), cy + r1 * np.sin(th1)],
                [z_lid] * 4)


def _host(x):
    """A member field as a float64 numpy array (the built geometry holds
    numpy arrays, or tensors once carried to a device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, float)


def mesh_fowt_members(fowt, dz_max=3.0, da_max=2.0, lid=True,
                      all_members=False) -> PanelMesh:
    """One combined mesh of all potMod members of a FOWTModel (reference:
    raft_fowt.py:607-614 meshes each potMod member into one shared list).

    Member positions are taken at the zero-offset pose (heading patterns
    already baked into rA0/rB0 at build).  ``all_members=True`` meshes
    every platform member regardless of its potMod flag (for validating
    the native solver on designs whose run configuration is strip-only)."""
    builder = _MeshBuilder()
    any_pot = False
    piercing = []
    for m in fowt.members[:fowt.nplatmems] if all_members else fowt.members:
        if not all_members and not m.potMod:
            continue
        if not m.circular:
            raise NotImplementedError(
                "panel meshing supports circular members only (the "
                "reference mesher has the same limitation, member2pnl.py)")
        any_pot = True
        rA, rB = _host(m.rA0), _host(m.rB0)
        mesh_member(_host(m.stations), _host(m.d), rA, rB,
                    dz_max=dz_max, da_max=da_max, builder=builder)
        # surface-piercing vertical members get an interior lid at z=0
        if rA[2] < 0.0 < rB[2] and abs(rA[0] - rB[0]) < 1e-9 \
                and abs(rA[1] - rB[1]) < 1e-9:
            st = _host(m.stations)
            dd = np.atleast_1d(_host(m.d))
            if dd.ndim == 0 or len(dd) == 1:
                dwl = float(dd.flat[0])
            else:
                z_st = rA[2] + (st - st[0]) / (st[-1] - st[0]) * (rB[2] - rA[2])
                dwl = float(np.interp(0.0, z_st, dd))
            piercing.append((rA[0], rA[1], 0.5 * dwl))
    if not any_pot:
        # IS a ValueError — pre-taxonomy catchers keep working
        raise ModelConfigError("FOWT has no potMod members to mesh")
    n_body = len(builder.panels)
    if lid:
        for cx, cy, R in piercing:
            lid_disk(builder, cx, cy, R, da_max, z_lid=-0.01 * da_max)
    mesh = builder.mesh()
    mesh.n_body = n_body
    return mesh


# --------------------------------------------------------------------------
# writers
# --------------------------------------------------------------------------

def write_pnl(mesh: PanelMesh, out_dir: str, body_only: bool = True):
    """HAMS HullMesh.pnl writer (reference: member2pnl.py:280-310).

    By default only the wetted BODY panels are written — interior-
    waterplane lid panels (our BEM core's irregular-frequency treatment)
    are not hull surface and would corrupt an external HAMS run."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "HullMesh.pnl")
    npan = mesh.nbody if body_only else mesh.npanels
    with open(path, "w") as f:
        f.write("    --------------Hull Mesh File---------------\n\n")
        f.write("    # Number of Panels, Nodes, X-Symmetry and Y-Symmetry\n")
        f.write(f"         {npan}         {len(mesh.verts)}"
                "         0         0\n\n")
        f.write("    #Start Definition of Node Coordinates     "
                "! node_number   x   y   z\n")
        for i, nd in enumerate(mesh.verts):
            f.write(f"{i+1:>5}{nd[0]:18.3f}{nd[1]:18.3f}{nd[2]:18.3f}\n")
        f.write("   #End Definition of Node Coordinates\n\n")
        f.write("   #Start Definition of Node Relations   ! panel_number  "
                "number_of_vertices   Vertex1_ID   Vertex2_ID   Vertex3_ID  "
                " (Vertex4_ID)\n")
        for i, p in enumerate(mesh.panels[:npan]):
            ids = list(p)
            if ids[3] == ids[2]:        # triangle
                row = [i + 1, 3] + [j + 1 for j in ids[:3]]
            else:
                row = [i + 1, 4] + [j + 1 for j in ids]
            f.write("".join(f"{v:>8}" for v in row) + "\n")
        f.write("   #End Definition of Node Relations\n\n")
        f.write("    --------------End Hull Mesh File---------------\n")
    return path


def write_gdf(mesh: PanelMesh, path: str, ulen=1.0, g=9.80665):
    """WAMIT .gdf writer (reference: member2pnl.py:496-546): panel
    vertices listed explicitly, no symmetry."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("gdf mesh written by raft_tpu\n")
        f.write(f"{ulen:>10.4f}{g:>10.4f}\n")
        f.write("0  0\n")
        f.write(f"{mesh.npanels}\n")
        for p in mesh.panels:
            for j in p:
                v = mesh.verts[j]
                f.write(f"{v[0]:>14.5f}{v[1]:>14.5f}{v[2]:>14.5f}\n")
    return path
