"""One kernel of the tree beside other sources of the same C entry points,
on one card:

    python -m cfd_taichi_tpu_torch.perf.coef_compare \\
        [--kernel coef_matvec|dfsph|coef_build|viscosity|fluid_terms|
                  boundary_terms|matvec|wcsph_forces|pcisph_predict|
                  pbf|rigid_side|rigid_gate|pcisph_body|body_box] \\
        [--variant NAME=PATH ...] [--bit-equal NAME] [--out PATH]

`--kernel` picks the source: csrc/coef_matvec.cu (the default, both
contractions; for `dfsph`, DFSPH's loop kernels dfsph_kick and dfsph_rate
in the forms the density loop ("kick", "rate") and the divergence loop
("kick_div", "rate_div") call them, beside the two contractions alone,
in f32 and bf16, each variant through the tree's entries),
csrc/coef_build.cu, csrc/viscosity.cu,
csrc/fluid_terms.cu, csrc/boundary_terms.cu, csrc/matvec.cu (both
recompute products, matvec and matvec_dot), csrc/wcsph_forces.cu or
csrc/pcisph_predict.cu (both forms of PCISPH's predicted density with
walls: the stream form over the inputs' pair store, "list", and the
stencil form, "stencil"; and
both without walls, "list_fluid" and "stencil_fluid") or, for `pbf`,
csrc/pbf_terms.cu, csrc/pbf_lambda.cu and csrc/pbf_xsph.cu together
(PBF's constraint pass in one launch, "constraint", without walls,
"constraint_clamp", and at a rest density of 800, "constraint_rho800",
where most rows are constrained; a source from before the one launch
runs its two raw entries followed by the torch algebra for each of
them; and the two streams over the tree's list, "lambda" and "xsph"),
or, for
`rigid_side`, csrc/rigid_side_force.cu (the body's reaction: the walk,
"walk", the list's rows, "rows", the list's build, "list", and the
stream over the tree's list of k and the scale m, "stream", and of u,
"stream_u", on perf/inputs.body_inputs and torus_inputs), or, for `rigid_gate`, csrc/rigid_terms.cu and
csrc/rigid_viscosity.cu (the solid sums, "terms", the contact dot,
"dot", and the solid viscosity, "visc", each with the body's gate made
once as a step makes it, with a gate that holds every query,
"terms_ungated", "dot_ungated" and "visc_ungated" (a gated call that
differs from its ungated one by a bit fails its check), and with one
that holds none, "terms_closed", "dot_closed" and "visc_closed"; and
csrc/body_box.cu, the gate's kernel, "box", beside its plain version,
"box_plain"; on the same inputs as rigid_side), or, for `pcisph_body`,
csrc/pcisph_predict.cu with the body: both forms of the predicted density
at the inputs' shifted positions, with the walls, over the body with its
gate made as a step makes it ("list", "stencil"), ungated ("list_ungated",
"stencil_ungated"; a gated call that differs from its ungated one by a
bit fails its check) and without the body ("list_nobody",
"stencil_nobody"): the body's walk is the call less the call without it,
printed for each source and form, by events and by device time; or, for
`body_box`, csrc/body_box.cu alone: the gate of the inputs' body ("box")
and of numpy-seeded clouds of 1, 31, 1024, 8191, 8193, 16,384, 16,385
and 39,146 particles ("box_n1", ...; `BOX_EDGES`), each bit for bit with
its plain
version, beside the plain version of the body's ("box_plain"). A
variant's PATH is a source of one of those files (it replaces the
tree's of its name), or
a directory: its `.cu` of the kernel's names
(else the tree's) are built beside its headers, which take the place of
the tree's (`#include "..."` looks beside the source first; the headers
it lacks come from the tree's csrc). For instance, the one-thread-per-query
coef_build of commit 3853c6a, and the tree's coef_build with 4-lane groups:

    mkdir -p build/pr3 build/g4
    git show 3853c6a:cfd_taichi_tpu_torch/csrc/coef_build.cu \\
        > build/pr3/coef_build.cu
    sed 's/kGroupWalk = 8;/kGroupWalk = 4;/' \\
        cfd_taichi_tpu_torch/csrc/stencil.cuh > build/g4/stencil.cuh
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel coef_build \\
        --variant pr3=build/pr3/coef_build.cu --variant g4=build/g4

Sources whose stencil.cuh takes the cubic kernel's q as r / h round W
and its gradient unlike the tree's (q = r * f32(1/h)): `--bit-equal`
against one of them reports the differences that alone makes.

A source from before boundary_terms_launch took the per-cell table
`bnear` and the boundary count needs the newer entry point put before it:

    mkdir -p build/before
    for f in stencil.cuh fluid_terms.cu boundary_terms.cu; do
        git show a4d16de:cfd_taichi_tpu_torch/csrc/$f > build/before/$f
    done
    sed -i s/boundary_terms_launch/boundary_terms_before/ \\
        build/before/boundary_terms.cu
    cat >> build/before/boundary_terms.cu <<'END'
    extern "C" int boundary_terms_launch(
        const float* q, int n, const float* bp, const float* bv,
        const int* bs, const int*, int, const StencilParams* p, float rho0,
        float* rho, float* s, float* qs, float* g2, void* stream) {
      return boundary_terms_before(q, n, bp, bv, bs, p, rho0, rho, s, qs,
                                   g2, stream);
    }
    END
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel \\
        boundary_terms --variant before=build/before --bit-equal before

DFSPH's loop kernels beside a source with the same entries (a parent
that changed no entry's arguments: an older one is compared from its own
tree), here the record form with other lanes a row and pairs a lane
loads ahead (kGroup changes the bits, kRecordUnroll does not):

    for v in "4 2" "4 4" "8 2" "16 2" "16 4"; do
        set -- $v; mkdir -p build/g$1u$2
        sed -e "s/kGroup = [0-9]*;/kGroup = $1;/" \\
            -e "s/kRecordUnroll = [0-9]*;/kRecordUnroll = $2;/" \\
            cfd_taichi_tpu_torch/csrc/coef_matvec.cu \\
            > build/g$1u$2/coef_matvec.cu
    done
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel dfsph \\
        --variant g8u2=build/g8u2 --variant g4u2=build/g4u2 ... \\
        --bit-equal g8u2

The bf16 engine's rate over the record rounded to bf16 at the table (8 B
a source, as the JAX engine rounds its product table; perf/dfsph_rec8.patch
adds the entry dfsph_rate_rec8_launch, whose pairs gather the bf16 record
and whose rows read v from the f32 one; the entries "rate_rec8" and
"rate_div_rec8" call it where a source has it, else the f32-record rate):

    mkdir -p build/rec8
    cp cfd_taichi_tpu_torch/csrc/coef_matvec.cu build/rec8
    patch -d build/rec8 -p0 < cfd_taichi_tpu_torch/perf/dfsph_rec8.patch
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel dfsph \\
        --variant rec8=build/rec8 --bit-equal tree

The predicted density's stream form with one lane a row (its terms
added in the stencil form's order) beside the tree's:

    mkdir -p build/g1
    sed 's/kPredictGroup = [0-9]*;/kPredictGroup = 1;/' \\
        cfd_taichi_tpu_torch/csrc/pcisph_predict.cu > build/g1/pcisph_predict.cu
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel \\
        pcisph_predict --variant g1=build/g1

PBF's constraint pass beside the composition before its one launch (the
two raw entries of 80c48fd's sources and the torch algebra; every output
and the list bit for bit), with a queue of 32 hits, and with the fluid
walk's candidates staged per block in shared memory (perf/pbf_tile.patch:
its capacity kPbfTile in 16-byte slots, its fill kPbfTileFill, 0 by the
block's threads as float4, 1 by bulk copies, cp.async.bulk, of xyz; the
queries a block kPbfThreads):

    mkdir -p build/v/parent build/v/q32 build/v/tile build/v/bulk
    for f in stencil.cuh pbf_terms.cu pbf_lambda.cu pbf_xsph.cu; do
        git show 80c48fd:cfd_taichi_tpu_torch/csrc/$f > build/v/parent/$f
    done
    sed 's/kPbfQueue = 40;/kPbfQueue = 32;/' \
        cfd_taichi_tpu_torch/csrc/pbf_terms.cu > build/v/q32/pbf_terms.cu
    cp cfd_taichi_tpu_torch/csrc/{stencil.cuh,pbf_terms.cu} build/v/tile
    patch -d build/v/tile -p0 < cfd_taichi_tpu_torch/perf/pbf_tile.patch
    sed 's/kPbfTileFill = 0;/kPbfTileFill = 1;/' build/v/tile/pbf_terms.cu \
        > build/v/bulk/pbf_terms.cu
    cp build/v/tile/stencil.cuh build/v/bulk
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel pbf \
        --variant parent=build/v/parent --variant q32=build/v/q32 \
        --variant tile=build/v/tile --variant bulk=build/v/bulk \
        --bit-equal parent

PBF's two streams with one lane a row and 8 pairs ahead (their terms
added in walk order, bit-equal to the walks they replace), and with 8
lanes and 2 ahead, beside the tree's:

    for v in "1 8" "8 2"; do
        set -- $v; mkdir -p build/g$1a$2
        for f in pbf_lambda pbf_xsph; do
            sed -e "s/Group = [0-9]*;/Group = $1;/" \\
                -e "s/Ahead = [0-9]*;/Ahead = $2;/" \\
                cfd_taichi_tpu_torch/csrc/$f.cu > build/g$1a$2/$f.cu
        done
    done
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel pbf \\
        --variant g1a8=build/g1a8 --variant g8a2=build/g8a2

The reaction's stream with other lanes a row and records ahead (kSideGroup,
kSideAhead), each against one lane a row bit for bit:

    for v in "1 4" "1 16" "2 8" "4 4"; do
        set -- $v; mkdir -p build/s$1a$2
        sed -e "s/kSideGroup = [0-9]*;/kSideGroup = $1;/" \\
            -e "s/kSideAhead = [0-9]*;/kSideAhead = $2;/" \\
            cfd_taichi_tpu_torch/csrc/rigid_side_force.cu \\
            > build/s$1a$2/rigid_side_force.cu
    done
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel rigid_side \\
        --variant s1a4=build/s1a4 --variant s1a16=build/s1a16 \\
        --variant s2a8=build/s2a8 --variant s4a4=build/s4a4 --bit-equal tree

The reaction's list (a group of kSideListGroup lanes a body particle,
kSideListChunk candidates a lane a round) and its stream beside the
sources of commit 4793ae7 (the list one thread a body particle on the
queued walk; a stream of u, which torch forms from k and m there:
`side_stream_call`), every output bit for bit with them, with other
groups and chunks, and with the stream's records 2 ahead:

    mkdir -p build/side_parent build/a2
    git show 4793ae7:cfd_taichi_tpu_torch/csrc/rigid_side_force.cu \
        > build/side_parent/rigid_side_force.cu
    for v in "8 1" "8 2" "16 1"; do
        set -- $v; mkdir -p build/l$1c$2
        sed -e "s/kSideListGroup = [0-9]*;/kSideListGroup = $1;/" \
            -e "s/kSideListChunk = [0-9]*;/kSideListChunk = $2;/" \
            cfd_taichi_tpu_torch/csrc/rigid_side_force.cu \
            > build/l$1c$2/rigid_side_force.cu
    done
    sed "s/kSideAhead = 1;/kSideAhead = 2;/" \
        cfd_taichi_tpu_torch/csrc/rigid_side_force.cu \
        > build/a2/rigid_side_force.cu
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel rigid_side \
        --variant parent=build/side_parent --variant l8c1=build/l8c1 \
        --variant l8c2=build/l8c2 --variant l16c1=build/l16c1 \
        --variant a2=build/a2 --bit-equal parent

The body's walk of the predicted density (the queued walk, one thread a
fluid row in the warps with a row inside the gate) beside 9359194's, every
output bit for bit with it, with other chunks (kPredictChunk: the fluid's
and the walls' walks take it too), and in the forms it was measured
against (perf/pcisph_body_<form>.patch, each applied to copies of
stencil.cuh and pcisph_predict.cu): a group of kBodyGroup lanes a row on
the reaction's ordered group walk, kBodyChunk candidates a lane a round
("groups"); one thread a row with its candidates streamed across the 9
runs ("streamed"), with its 9 runs' bounds loaded at once ("preloaded"),
with no queue, each hit's term added as found ("direct"), with kBodyDrain
hits a drain turn ("drain4"), over 16-byte records [x, y, z, V] that a
kernel of each call packs, kRecordChunk candidates a chunk ("records");
and a launch of its own over a list of the rows inside the gate (slots
taken by an atomic, the list's count zeroed by a memset each call),
kOwnGroup lanes a row on the ordered group walk ("own"), which the
walk's figures count by every kernel of the call; and the gate's
fold (one block, or a cluster above kBoxOneBlock particles) beside
9359194's one block, and with other thresholds, block widths and
cluster sizes (over 8 blocks needs the non-portable size, which the
launch asks for):

    mkdir -p build/body_parent build/box_parent
    for f in stencil.cuh pcisph_predict.cu; do
        git show 9359194:cfd_taichi_tpu_torch/csrc/$f > build/body_parent/$f
    done
    git show 9359194:cfd_taichi_tpu_torch/csrc/body_box.cu \\
        > build/box_parent/body_box.cu
    for form in groups streamed preloaded direct drain4 records own; do
        mkdir -p build/$form
        cp cfd_taichi_tpu_torch/csrc/{stencil.cuh,pcisph_predict.cu} \\
            build/$form
        patch -d build/$form -p0 \\
            < cfd_taichi_tpu_torch/perf/pcisph_body_$form.patch
    done
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel pcisph_body \\
        --variant parent=build/body_parent --variant groups=build/groups \\
        --variant streamed=build/streamed \\
        --variant preloaded=build/preloaded --variant direct=build/direct \\
        --variant drain4=build/drain4 --variant records=build/records \\
        --variant own=build/own --bit-equal parent
    for v in "8192 512" "24576 512" "16384 1024"; do
        set -- $v; mkdir -p build/o$1t$2
        sed -e "s/kBoxOneBlock = [0-9]*;/kBoxOneBlock = $1;/" \\
            -e "s/kBoxThreads = [0-9]*;/kBoxThreads = $2;/" \\
            cfd_taichi_tpu_torch/csrc/body_box.cu > build/o$1t$2/body_box.cu
    done
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel body_box \\
        --variant parent=build/box_parent --variant o8192t512=build/o8192t512 \\
        --variant o24576t512=build/o24576t512 \\
        --variant o16384t1024=build/o16384t1024 --bit-equal parent

The reaction's walk (a group of kSideWalkGroup lanes a body particle,
kSideWalkChunk candidates a lane a round) beside the one-thread walk of
commit 643b61d, every output bit for bit with it, and with other groups
and chunks:

    mkdir -p build/side_before
    for f in stencil.cuh rigid_side_force.cu; do
        git show 643b61d:cfd_taichi_tpu_torch/csrc/$f > build/side_before/$f
    done
    for v in "8 2" "8 4" "16 1" "32 1"; do
        set -- $v; mkdir -p build/w$1c$2
        sed -e "s/kSideWalkGroup = [0-9]*;/kSideWalkGroup = $1;/" \\
            -e "s/kSideWalkChunk = [0-9]*;/kSideWalkChunk = $2;/" \\
            cfd_taichi_tpu_torch/csrc/rigid_side_force.cu \\
            > build/w$1c$2/rigid_side_force.cu
    done
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel rigid_side \\
        --variant before=build/side_before --variant w8c2=build/w8c2 \\
        --variant w8c4=build/w8c4 --variant w16c1=build/w16c1 \\
        --variant w32c1=build/w32c1 --bit-equal before

The solid sums before their gate (commit 643b61d, whose entry point has
no gate: renamed, and called through one that takes it and ignores it),
bit for bit against the tree's gated and ungated launches (its "closed"
entries walk every query all the same, so their checks fail):

    mkdir -p build/terms_before
    git show 643b61d:cfd_taichi_tpu_torch/csrc/rigid_terms.cu \\
        | sed s/rigid_terms_launch/rigid_terms_before/ \\
        > build/terms_before/rigid_terms.cu
    cat >> build/terms_before/rigid_terms.cu <<'END'
    extern "C" int rigid_terms_launch(
        const float* pos, int n, const float* rpos, const float* rvol,
        const int* rstarts, int nr, const StencilParams* p, float rho0,
        const float*, float* rho, float* s, float* qsum, float* g2,
        void* stream) {
      return rigid_terms_before(pos, n, rpos, rvol, rstarts, nr, p, rho0,
                                rho, s, qsum, g2, stream);
    }
    END
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel rigid_gate \\
        --variant before=build/terms_before --bit-equal before

The contact dot and the solid viscosity with chunks of 16 candidates
(kRigidChunk, kViscChunk) and with 4 hits a drain turn (kDrainUnroll, in
a copy of stencil.cuh), each against the tree's bit for bit:

    mkdir -p build/c16 build/u4
    for f in rigid_terms rigid_viscosity; do
        sed 's/Chunk = 8;/Chunk = 16;/' cfd_taichi_tpu_torch/csrc/$f.cu \\
            > build/c16/$f.cu
    done
    sed 's/kDrainUnroll = 2;/kDrainUnroll = 4;/' \\
        cfd_taichi_tpu_torch/csrc/stencil.cuh > build/u4/stencil.cuh
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel rigid_gate \\
        --variant c16=build/c16 --variant u4=build/u4 --bit-equal tree

The recompute products before they took the queued walk (pair term in the
candidate loop), and the tree's with a queue of 32 hits a thread:

    mkdir -p build/mv_before build/mv_q32
    for f in stencil.cuh matvec.cu; do
        git show 245dfac:cfd_taichi_tpu_torch/csrc/$f > build/mv_before/$f
    done
    sed 's/kMatvecQueue = [0-9]*;/kMatvecQueue = 32;/' \\
        cfd_taichi_tpu_torch/csrc/matvec.cu > build/mv_q32/matvec.cu
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel matvec \\
        --variant before=build/mv_before --variant q32=build/mv_q32 \\
        --bit-equal before

wcsph_forces before its packed records, beside the tree's with chunks of
10 candidates; the older entry point, which reads pos, vel, rho and p' as
they are, is renamed, and such a source is called through it with no
record built (the tree's call builds its records, so its time is net of
them):

    mkdir -p build/wc_before build/wc_c10
    for f in stencil.cuh wcsph_forces.cu; do
        git show 7fcfb05:cfd_taichi_tpu_torch/csrc/$f > build/wc_before/$f
    done
    sed -i s/wcsph_forces_launch/wcsph_forces_fields_launch/ \\
        build/wc_before/wcsph_forces.cu
    sed 's/kWcsphChunk = [0-9]*;/kWcsphChunk = 10;/' \\
        cfd_taichi_tpu_torch/csrc/wcsph_forces.cu > build/wc_c10/wcsph_forces.cu
    python -m cfd_taichi_tpu_torch.perf.coef_compare --kernel wcsph_forces \\
        --variant before=build/wc_before --variant c10=build/wc_c10 \\
        --bit-equal before

Each source, the tree's ("tree") first, is built into its own library
(build/compare/<kernel>/<name>/; one that does not build is reported and
left out) and called through the port's wrappers with that library in
place of the tree's. It is checked against the plain version on
breaking_dam_1m's and breaking_dam_30k's jittered lattices (rigid_side
and rigid_gate: on their blocks with a body, perf/inputs.body_inputs)
and, for the
contraction, on two ragged engines of 1000 and 1003 rows (lane sums to
1e-5 of each lane's largest value), for those two on the half-immersed
torus (perf/inputs.torus_inputs), else on the clustered cloud of
chip_smoke.py
(perf/inputs.py; coef_build: nbr exactly, w as perf/cases.build_error
says; viscosity, matvec, matvec_dot and wcsph_forces: 1e-5 of the largest
value;
fluid_terms and
boundary_terms, the latter over the cloud's boundary set: count exactly,
every sum to 1e-5 of its largest value). With `--bit-equal NAME` every
output of every source is also compared bit for bit with that of variant
NAME on the same inputs (the queued walk adds a query's terms in the
order of the one-thread walk, so it must not differ at all); a
difference of the tree's counts as a failed check. Then it is timed, the
coef kernels in f32 and bf16 storage: on the 1M lattice (and the
clustered cloud), CUDA events around 20 back-to-back calls, over the
count, in 4 rounds that visit the sources forward and backward in turn
(median of the rounds), and torch.profiler's device time per launch
(which alone times a kernel shorter than its call's host work, ~60 us)
beside the device time of all the kernels of a call (wcsph_forces' record
build); and at 30k, the device times. Prints one line per measurement
and writes the whole as JSON (--out); exits 1 if a check failed.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import shutil
import statistics
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.ops import _build, coef
from cfd_taichi_tpu_torch.ops import stencil as S
from cfd_taichi_tpu_torch.ops.neighbors import cell_id, stencil_counts
from cfd_taichi_tpu_torch.ops.smoothing import f32
from cfd_taichi_tpu_torch.perf import cases, inputs, timing

COMPARE_DIR = _build.BUILD_DIR.parent / "compare"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SOURCES = {"coef_matvec": ("coef_matvec.cu",),
           "dfsph": ("coef_matvec.cu",),
           "coef_build": ("coef_build.cu",), "viscosity": ("viscosity.cu",),
           "fluid_terms": ("fluid_terms.cu",),
           "boundary_terms": ("boundary_terms.cu",),
           "matvec": ("matvec.cu",), "wcsph_forces": ("wcsph_forces.cu",),
           "pcisph_predict": ("pcisph_predict.cu",),
           "pbf": ("pbf_terms.cu", "pbf_lambda.cu", "pbf_xsph.cu"),
           "rigid_side": ("rigid_side_force.cu",),
           "rigid_gate": ("rigid_terms.cu", "rigid_viscosity.cu",
                          "body_box.cu"),
           "pcisph_body": ("pcisph_predict.cu",),
           "body_box": ("body_box.cu",)}
# body_box's edge sizes: one particle, less than a warp, a block's
# threads, two passes (kBoxThreads x kBoxUnroll) less and more one,
# the most it takes alone (kBoxOneBlock) and one more, the first a cluster
# folds, and the 1M block's body
BOX_EDGES = (1, 31, 1024, 8191, 8193, 16_384, 16_385, 39_146)
# The forms of the predicted density that --kernel pcisph_body runs, by
# the kernel's name: (label, pair store or not)
BODY_FORMS = (("list", "pcisph_predict_rho_list"),
              ("stencil", "pcisph_predict_rho"))
# The entry point of a wcsph_forces source from before the packed records,
# renamed so (see above): (pos, starts, n, params, m, nu_num, q2e_add,
# tension_mk, vel, rho, p', out, stream).
FIELDS_ENTRY = "wcsph_forces_fields_launch"
CLUSTERED_N = 100_000
ROUNDS = 4
TOL = 1e-5


def _tensors(out) -> list[torch.Tensor]:
    return [out] if isinstance(out, torch.Tensor) else list(out)


class Entry(NamedTuple):
    label: str                 # what is called, e.g. "f32/coef_matvec"
    kernel: str | None         # the kernel's name in the profiler; None:
    #                            a library call, timed by all its kernels
    call: Callable             # one call through the wrapper
    check: Callable[[], float]  # error of a call against the plain version
    # the output tensors of a call that are compared bit for bit
    outputs: Callable = _tensors


def build_variants(kernel: str, sources: dict[str, Path]) -> dict:
    """{name: KernelLibrary} of the sources that build, each on its own."""
    srcs = {}
    for name, path in sources.items():
        path, vdir = Path(path), COMPARE_DIR / kernel / name
        shutil.rmtree(vdir, ignore_errors=True)
        vdir.mkdir(parents=True)
        if path.is_dir():
            for f in path.glob("*.cuh"):
                shutil.copy(f, vdir / f.name)
        srcs[name] = []
        for fname in SOURCES[kernel]:
            if path.is_dir() and (path / fname).exists():
                src = path / fname
            elif path.name == fname or (path.is_file()
                                        and len(SOURCES[kernel]) == 1):
                src = path
            else:
                src = _build._CSRC / fname
            srcs[name].append(vdir / fname)
            shutil.copy(src, vdir / fname)

    def build(name):
        lib = srcs[name][0].parent / f"lib_{kernel}.so"
        try:
            _build.build_shared({lib: srcs[name]})
        except RuntimeError as e:
            print(f"[compare] {name} does not build, left out:\n{e}")
            return None
        return _build.KernelLibrary(lib, 0.0,
                                    lib.with_suffix(".log").read_text())

    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(build, srcs)))
    return {name: lib for name, lib in built.items() if lib is not None}


@contextlib.contextmanager
def using(lib):
    """The wrappers launch from `lib` inside the block."""
    saved = _build._LIBRARY
    _build._LIBRARY = lib
    try:
        yield
    finally:
        _build._LIBRARY = saved


def _scene(x: dict) -> tuple:
    """(grid, h, m) of lattice inputs (a scene) or the clustered cloud."""
    if "sc" in x:
        return x["sc"].grid, x["sc"].h, x["sc"].particle_m
    return x["grid"], x["h"], x["m"]


def wcsph_call(args: tuple) -> torch.Tensor:
    """wcsph_forces(*args) from the library in use: through the wrapper,
    which builds the records, or, for a source from before them, through
    its older entry point on pos, vel, rho and p' as they are."""
    lib = _build.library().lib
    entry = getattr(lib, FIELDS_ENTRY, None)
    if entry is None:
        return S.wcsph_forces(*args, **cases.WCSPH)
    p, st, g, h, m, v, rho, pr = args
    P, F = ctypes.c_void_p, ctypes.c_float
    entry.argtypes = [P, P, ctypes.c_int, ctypes.POINTER(_build.StencilParams),
                      F, F, F, F, P, P, P, P, P]
    entry.restype = ctypes.c_int
    w = cases.WCSPH
    nu_num, q2e_add = S._viscosity_constants(h, w["c_s"], w["alpha"], 0.01)
    out = p.new_empty(p.shape[0], 3)
    rc = entry(*(P(t.data_ptr()) for t in (p, st)), p.shape[0],
               ctypes.byref(S._params(g, h)), f32(m), nu_num, q2e_add,
               S._tension_mk(w["tension_k"], m),
               *(P(t.data_ptr()) for t in (v, rho, pr, out)),
               P(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"{FIELDS_ENTRY} failed: cudaError_t {rc}")
    return out


def contraction_entries(engs: dict, pos, k, v) -> list[Entry]:
    out = []
    for d, eng in engs.items():
        for op, fn, plain, src, _ in cases.CONTRACTIONS:
            arg = k if src == "k" else v
            want = plain(eng, pos, arg, lane_sums=True)
            out.append(Entry(
                f"{d}/{op}", op, functools.partial(fn, eng, pos, arg),
                lambda fn=fn, eng=eng, arg=arg, want=want: cases.lane_error(
                    fn(eng, pos, arg, lane_sums=True), want)))
    return out


# dfsph_rate_rec8_launch of perf/dfsph_rec8.patch: the rate's arguments
# with the bf16 record after the f32 one, and no storage flag (bf16 w).
_P, _I = ctypes.c_void_p, ctypes.c_int
REC8_ARGS = (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
             ctypes.c_float, _P, _P, _P, _P, _P, _P)


def rec8_call(case: cases.Case, rec8: torch.Tensor):
    """`case` (dfsph_rate on a bf16 engine) through the library's
    dfsph_rate_rec8_launch over `rec8`, its record rounded to bf16, or,
    for a library without it, as the tree's wrapper calls it."""
    lib = _build.library().lib
    entry = getattr(lib, "dfsph_rate_rec8_launch", None)
    if entry is None:
        return case.kern()
    entry.argtypes = REC8_ARGS
    eng, p, rec, S_, alpha, rho, dt, mode, c_s, owned = (
        *case.kern.args, None, None)[:10]
    n, dev = p.shape[0], p.device
    div = isinstance(mode, coef.Divergence)
    out = coef.Rate(p.new_empty(n) if div else None, p.new_empty(n),
                    p.new_empty(n), torch.empty(n, dtype=torch.bool,
                                                device=dev))
    S._launch("dfsph_rate", dev, p, n, eng.offsets, eng.nbr, eng.w, rec,
              rec8, S_, c_s, mode.counts if div else None,
              mode.min_neighbors if div else 0, alpha, rho, dt,
              None if div else mode.dt2, 0.0 if div else f32(mode.rho0),
              owned, *out, entry="dfsph_rate_rec8")
    return out


def fused_check(name: str, call: Callable, want, scales: dict) -> float:
    """A DFSPH loop kernel's call against the plain version's outputs
    `want` (cases.fused_error): the largest error over its scale, inf
    where the selection differs away from the threshold."""
    e = cases.fused_error(name, call(), want, scales, TOL)
    if not e["ok"]:
        return float("inf")
    return max(e[key] / max(scales[key[4:]], 1e-30)
               for key in e if key.startswith("err_"))


def dfsph_entries(x: dict, p, st, g, h: float, m: float) -> list[Entry]:
    """dfsph_kick and dfsph_rate (their wrappers) on f32 and bf16 engines of
    `p`, as the density loop and the divergence loop call them
    (perf/cases.dfsph_cases), each checked against its plain version
    (cases.fused_error: the largest error over its scale, inf where the
    selection differs away from the threshold), and the two contractions
    alone on the same engines. Timed by all the kernels of a call."""
    off = coef.csr_offsets(S.fluid_terms(p, st, g, h, m).count)
    d = cases.dfsph_inputs(p, st, g, h, m, x["rho"], seed=11)
    out = []
    for dname, dtype in DTYPES.items():
        eng = coef.build_coef(p, st, g, h, m, off, dtype)
        for case in cases.dfsph_cases(eng, p, x["v"], x["k"], d):
            want, scales = case.plain(), case.scales()
            label = f"{dname}/{case.key.replace('dfsph_', '')}"
            calls = {label: case.kern}
            if dname == "bf16" and case.name == "dfsph_rate":
                calls[label + "_rec8"] = functools.partial(
                    rec8_call, case, case.kern.args[2].to(torch.bfloat16))
            for lab, call in calls.items():
                out.append(Entry(lab, None, call, functools.partial(
                    fused_check, case.name, call, want, scales),
                    lambda o: [t for t in cases.bits(o) if t is not None]))
        out += contraction_entries({dname: eng}, p, x["k"], x["v"])
    return out


def entries(kernel: str, x: dict) -> list[Entry]:
    """The kernel's calls on inputs `x` (perf/inputs.py), each with its
    check; the coef kernels once per storage dtype. Engines and offsets
    come from the tree's kernels."""
    g, h, m = _scene(x)
    p, st = x["p"], x["st"]
    if kernel in ("fluid_terms", "boundary_terms"):
        if kernel == "fluid_terms":
            call = functools.partial(S.fluid_terms, p, st, g, h, m)
            want = S.fluid_terms_plain(p, st, g, h, m)
        else:
            sc = x.get("sc")
            bnd = ((sc.boundary_pos, sc.boundary_volume, sc.boundary_starts)
                   if sc else (x["bp"], x["bvol"], x["bst"])) + (g, h, 1000.0)
            call = functools.partial(S.boundary_terms, p, *bnd,
                                     stencil_counts(bnd[2], g))
            want = S.boundary_terms_plain(p, *bnd)
        return [Entry("f32", kernel, call,
                      lambda: cases.terms_error(call(), want))]
    if kernel == "matvec":
        out = []
        for name, fn, plain, arg in (
                ("matvec", S.matvec, S.matvec_plain, x["k"]),
                ("matvec_dot", S.matvec_dot, S.matvec_dot_plain, x["v"])):
            call = functools.partial(fn, p, st, g, h, m, arg)
            want = plain(p, st, g, h, m, arg)
            out.append(Entry(name, name, call,
                             lambda call=call, want=want:
                             cases.scaled_error(call(), want)))
        return out
    if kernel == "wcsph_forces":
        args = (p, st, g, h, m, x["v"], x["rho"], x["pr"])
        want = S.wcsph_forces_plain(*args, **cases.WCSPH)
        call = functools.partial(wcsph_call, args)
        return [Entry("f32", kernel, call,
                      lambda: cases.scaled_error(call(), want))]
    if kernel == "pcisph_predict":
        sc = x.get("sc")
        walls = base.walls(sc) if sc else S.Walls(x["bp"], x["bvol"],
                                                   x["bst"], x["bnear"])
        args = (p, st, g, h, m, x["shifted"], walls, cases.RHO0)
        eng = cases.pair_store(p, st, g, h, m)
        out = []
        for sfx, a in (("", args), ("_fluid", args[:6])):
            for label, kname, store, plain in (
                    ("list", "pcisph_predict_rho_list", eng,
                     lambda a=a: S.pcisph_predict_rho_list_plain(
                         eng, p, *a[2:])),
                    ("stencil", "pcisph_predict_rho", None,
                     lambda a=a: S.pcisph_predict_rho_plain(*a))):
                call = functools.partial(S.pcisph_predict_rho, *a,
                                         eng=store)
                want = plain()
                out.append(Entry(label + sfx, kname, call,
                                 lambda call=call, want=want:
                                 cases.scaled_error(call(), want)))
        return out
    if kernel == "pbf":
        return pbf_entries(x, p, st, g, h, m)
    if kernel == "dfsph":
        return dfsph_entries(x, p, st, g, h, m)
    if kernel == "rigid_side":
        return rigid_side_entries(x)
    if kernel == "rigid_gate":
        return rigid_gate_entries(x)
    if kernel == "pcisph_body":
        return pcisph_body_entries(x)
    if kernel == "body_box":
        return body_box_entries(x)
    if kernel == "viscosity":
        args = (p, st, g, h, m, x["v"], x["rho"])
        want = S.viscosity_plain(*args, **cases.VISC)
        return [Entry("f32", "viscosity",
                      lambda: S.viscosity(*args, **cases.VISC),
                      lambda: cases.scaled_error(
                          S.viscosity(*args, **cases.VISC), want))]
    off = coef.csr_offsets(S.fluid_terms(p, st, g, h, m).count)
    if kernel == "coef_matvec":
        return contraction_entries(
            {d: coef.build_coef(p, st, g, h, m, off, dt)
             for d, dt in DTYPES.items()}, p, x["k"], x["v"])
    pairs = int(off[-1])
    out = []
    for d, dt in DTYPES.items():
        want = coef.build_coef_plain(p, st, g, h, m, off, dt)
        call = functools.partial(coef.build_coef, p, st, g, h, m, off, dt,
                                 pairs)

        def check(call=call, want=want):
            e = cases.build_error(call(), want)
            return e["w_err"] if e["ok"] else float("inf")
        out.append(Entry(d, "coef_build", call, check))
    return out


def _raw_call(entry, *args) -> None:
    """Call C entry point `entry` of the library in use on `args` (tensors
    as their data pointers, ints as int, floats as float, ctypes.byref as
    they are) and the current stream."""
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
             else ctypes.c_int(a) if isinstance(a, int)
             else ctypes.c_float(a) if isinstance(a, float) else a
             for a in args]
    entry.restype = ctypes.c_int
    rc = entry(*cargs,
               ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"{entry.__name__} failed: cudaError_t {rc}")


def constraint_call(*args):
    """PBF's constraint pass (`stencil.pbf_constraint`'s arguments) from the
    library in use: its one launch or, for a source from before it, its
    two raw entries, pbf_terms_launch (pos, starts, n, params, spiky, m,
    inv_wref, neg_k, base, cnt, nbr, rho, gsum, around, ssum, stream) and
    pbf_boundary_terms_launch (pos, n, bpos, bvol, bstarts, bnear, nb,
    params, spiky, rho0, inv_wref, neg_k, rho, gsum, around, ssum, stream),
    followed by the rows' algebra (`stencil.pbf_rows_plain`), as
    models/pbf.solve took them there."""
    lib = _build.library().lib
    if getattr(lib, "pbf_constraint_launch", None) is not None:
        return S.pbf_constraint(*args)
    p, st, g, h, m, wr, kc, rows, walls, rho0, eps, seed = args
    n = p.shape[0]
    kern = (ctypes.byref(S._params(g, h)), ctypes.byref(S._spiky_poly6(h)))
    consts = S._s_corr_constants(wr, kc)

    def sums():
        return S.PbfTerms(p.new_empty(n), p.new_empty(n, 3), p.new_empty(n),
                          p.new_empty(n, 3))

    pairs = S.PairList(rows.base, torch.empty_like(rows.base),
                       torch.empty(rows.size, dtype=torch.int32,
                                   device=p.device))
    fluid = sums()
    _raw_call(lib.pbf_terms_launch, p, st, n, *kern, f32(m), *consts, *pairs,
              *fluid)
    wall = None
    if walls is not None:
        wall = sums()
        _raw_call(lib.pbf_boundary_terms_launch, p, n, *walls,
                  walls.pos.shape[0], *kern, f32(rho0), *consts, *wall)
    return S.pbf_rows_plain(fluid, wall, rho0, eps, seed), pairs


def pbf_entries(x: dict, p, st, g, h: float, m: float) -> list[Entry]:
    """PBF's constraint pass, pbf_terms' one launch ("constraint": the fluid
    walk with its store of the pair list, the walls' walk and the rows'
    lambda; "constraint_clamp" without walls; "constraint_rho800" with
    walls at cases.LOW_RHO0, where most rows are constrained), each
    against the plain version (constraint, lambda, gsum and ssum to 1e-5
    of scale, each row's count and sources exactly; "constraint_rho800"
    fails with no constrained row), and the two streams over the tree's
    list of the same inputs ("lambda" of x["lam"], "xsph" at x["shifted"]
    with velocities x["v"]). A source from before the one launch runs its
    two raw entries and the torch algebra for each constraint entry
    (`constraint_call`), which `--bit-equal` holds the one launch to."""
    rows = S.pair_rows(st, g, cell_id(p, g))
    sc = x.get("sc")
    walls = base.walls(sc) if sc else S.Walls(x["bp"], x["bvol"], x["bst"],
                                              x["bnear"])
    with_walls = cases.pbf_constraint_args(p, st, g, h, m, rows, walls)
    clamp = cases.pbf_constraint_args(p, st, g, h, m, rows, None)
    low = cases.pbf_constraint_args(p, st, g, h, m, rows, walls,
                                    cases.LOW_RHO0)
    _, pl = S.pbf_constraint(*with_walls)
    lam, sp, v = x["lam"], x["shifted"], x["v"]

    def listed(out):
        return [*out[0], out[1].cnt, S.stored_pairs(out[1])[1]]

    def constraint_entry(label, args, constrained):
        call = functools.partial(constraint_call, *args)
        want = listed(S.pbf_constraint_plain(*args))

        def check():
            got = listed(call())
            if not (all(torch.equal(a, b) for a, b in zip(got[4:], want[4:]))
                    and (not constrained or bool((got[1] != 0).any()))):
                return float("inf")
            return max(cases.scaled_error(a, b)
                       for a, b in zip(got[:4], want[:4]))
        return Entry(label, "pbf_terms", call, check, listed)

    lam_want = S.pbf_lambda_list_plain(pl, p, h, lam)
    xsph_want = S.pbf_xsph_list_plain(pl, h, sp, v)
    lam_call = functools.partial(S.pbf_lambda, p, pl, h, lam)
    xsph_call = functools.partial(S.pbf_xsph, pl, h, sp, v)
    return [constraint_entry("constraint", with_walls, False),
            constraint_entry("constraint_clamp", clamp, False),
            constraint_entry("constraint_rho800", low, True),
            Entry("lambda", "pbf_lambda", lam_call,
                  lambda: cases.scaled_error(lam_call(), lam_want)),
            Entry("xsph", "pbf_xsph", xsph_call,
                  lambda: cases.scaled_error(xsph_call(), xsph_want))]


def side_stream_call(side, value: torch.Tensor, force: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """rigid_side_force_list(side, value, force, scale) from the library in
    use: through the wrapper, or, for a source from before the stream
    formed u at its gather (its entry rigid_side_force_list_launch takes
    u), u = value * f32(scale) by torch and that entry, as that tree's
    density loop launches the two."""
    from cfd_taichi_tpu_torch.ops import rigid as R

    lib = _build.library().lib
    if hasattr(lib, "rigid_side_stream_launch"):
        return R.rigid_side_force_list(side, value, force, scale)
    entry = lib.rigid_side_force_list_launch
    entry.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7
    entry.restype = ctypes.c_int
    u = value if scale == 1.0 else value * f32(scale)
    out = torch.empty_like(force)
    rc = entry(side.base.shape[0], *(ctypes.c_void_p(t.data_ptr()) for t in
                                     (*side, u, force, out)),
               ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"rigid_side_force_list_launch failed: "
                           f"cudaError_t {rc}")
    return out


def rigid_side_entries(x: dict) -> list[Entry]:
    """The body's reaction on coupled inputs `x`: the walk of x["u"] on
    x["force"] ("walk"), the list's rows ("rows": exactly), the list's
    build ("list": each row's count and fluid indices exactly, g to 1e-5
    of scale, against the plain version; bit for bit the counts, indices
    and g), the stream over the tree's list as DFSPH's density loop calls
    it, of x["k"] and the scale m ("stream"; `side_stream_call`: a source
    from before the scale is timed with torch's u = k m), and of x["u"]
    alone ("stream_u": the kernel's own change), and the library yardstick
    on that list of u = k m ("addmv", perf/cases.side_library_calls)."""
    from cfd_taichi_tpu_torch.ops import rigid as R

    rows_args = (x["rpos"], x["st"], x["grid"])
    rows_want = R.rigid_side_rows_plain(*rows_args)
    rows = functools.partial(R.rigid_side_rows, *rows_args)

    walk_args = (x["rpos"], x["rvol"], x["p"], x["st"], x["grid"], x["h"],
                 cases.RHO0, x["u"], x["force"])
    build, side = cases.side_list(x)
    listed = cases.side_list_view
    want_list = listed(R.rigid_side_list_plain(*build))

    def check_list():
        got = listed(R.rigid_side_list(*build))
        if not all(torch.equal(a, b) for a, b in zip(got[:2], want_list)):
            return float("inf")
        return cases.scaled_error(got[2], want_list[2])

    walk = functools.partial(R.rigid_side_force, *walk_args)
    walk_want = R.rigid_side_force_plain(*walk_args)
    m = x["m"]
    stream = functools.partial(side_stream_call, side, x["k"], x["force"], m)
    stream_want = R.rigid_side_force_list_plain(side, x["k"], x["force"], m)
    stream_u = functools.partial(side_stream_call, side, x["u"], x["force"],
                                 1.0)
    stream_u_want = R.rigid_side_force_list_plain(side, x["u"], x["force"])
    addmv = cases.side_library_calls(side, x["k"] * f32(m),
                                     x["force"])["addmv"]
    return [Entry("walk", "rigid_side_force", walk,
                  lambda: cases.scaled_error(walk(), walk_want)),
            Entry("rows", "rigid_side_rows", rows,
                  lambda: 0.0 if torch.equal(rows(), rows_want)
                  else float("inf")),
            Entry("list", "rigid_side_list",
                  functools.partial(R.rigid_side_list, *build), check_list,
                  listed),
            Entry("stream", "rigid_side_force_list", stream,
                  lambda: cases.scaled_error(stream(), stream_want)),
            Entry("stream_u", "rigid_side_force_list", stream_u,
                  lambda: cases.scaled_error(stream_u(), stream_u_want)),
            Entry("addmv", None, addmv,
                  lambda: cases.scaled_error(addmv(), stream_want))]


def rigid_gate_entries(x: dict) -> list[Entry]:
    """The solid sums ("terms"), the contact dot ("dot") and the solid
    viscosity ("visc") on coupled inputs `x`, gated by the body's box
    (perf/cases.gated_calls), ungated ("..._ungated"), each against the
    plain version (a gated call must also give its ungated call's bits),
    and with a gate that holds no query ("..._closed": every output 0;
    what the warps that take no walk cost, the gated kernel's floor); and
    the gate's kernel ("box", bit for bit with its plain version,
    "box_plain", timed by all its kernels)."""
    box = cases.gate_box(x)
    open_box = cases.ungated_box(box.device)
    closed = open_box.flip(0).contiguous()
    out = []
    for label, (name, (call, plain)) in zip(
            ("terms", "dot", "visc"), cases.gated_calls(x).items()):
        want = plain()

        def check(call=call, want=want, gated=True):
            got = call(box if gated else open_box)
            if gated and not cases.same_bits(got, call(open_box)):
                return float("inf")
            return cases.terms_error(got, want)

        def check_closed(call=call):
            return 0.0 if all(bool((t == 0).all()) for t in cases.tensors(
                call(closed))) else float("inf")
        out += [Entry(label, name, functools.partial(call, box), check),
                Entry(f"{label}_ungated", name,
                      functools.partial(call, open_box),
                      functools.partial(check, gated=False)),
                Entry(f"{label}_closed", name,
                      functools.partial(call, closed), check_closed)]
    bpos, h = x["table"].pos, x["h"]
    want = S.make_body_box_plain(bpos, h)
    return out + [
        Entry("box", "body_box", functools.partial(S.make_body_box, bpos, h),
              lambda: 0.0 if torch.equal(S.make_body_box(bpos, h), want)
              else float("inf")),
        Entry("box_plain", None,
              functools.partial(S.make_body_box_plain, bpos, h),
              lambda: 0.0)]


def pcisph_body_entries(x: dict) -> list[Entry]:
    """PCISPH's predicted density on coupled inputs `x` at x["shifted"],
    with the scene's walls, in both forms (`BODY_FORMS`: the stream form
    over the pair store of x["p"], "list", and the stencil form,
    "stencil"): with the body and its gate made as a step makes it, each
    against the plain version and bit for bit with the same launch
    ungated; ungated ("..._ungated"); and without the body
    ("..._nobody"), against the plain version without it."""
    g, h, m, p, st = (x[k] for k in ("grid", "h", "m", "p", "st"))
    predict = (p, st, g, h, m, x["shifted"], base.walls(x["sc"]),
               cases.RHO0)
    eng = cases.pair_store(p, st, g, h, m)
    box = cases.gate_box(x)
    open_box = cases.ungated_box(box.device)
    out = []
    for label, name in BODY_FORMS:
        store = eng if label == "list" else None

        def plain(body, store=store):
            if store is None:
                return S.pcisph_predict_rho_plain(*predict, body)
            return S.pcisph_predict_rho_list_plain(store, p, *predict[2:],
                                                   body)

        def call(b, body=x["table"], store=store):
            return S.pcisph_predict_rho(*predict, body, store, b)

        want, want_none = plain(x["table"]), plain(None)

        def check(call=call, want=want, gated=True):
            got = call(box if gated else open_box)
            if gated and not torch.equal(got, call(open_box)):
                return float("inf")
            return cases.scaled_error(got, want)
        out += [Entry(label, name, functools.partial(call, box), check),
                Entry(f"{label}_ungated", name,
                      functools.partial(call, open_box),
                      functools.partial(check, gated=False)),
                Entry(f"{label}_nobody", name,
                      functools.partial(call, None, None),
                      lambda call=call, want=want_none: cases.scaled_error(
                          call(None, None), want))]
    return out


def body_box_entries(x: dict) -> list[Entry]:
    """The body's gate on coupled inputs `x` ("box") and on numpy-seeded
    clouds of `BOX_EDGES` particles ("box_n<nr>", coordinates uniform in
    [-3, 5) m), each bit for bit with its plain version; and the plain
    version of the body's ("box_plain", timed by all its kernels)."""
    import numpy as np

    h = x["h"]
    dev = x["p"].device
    rng = np.random.default_rng(13)
    clouds = {"box": x["table"].pos, **{
        f"box_n{nr}": torch.from_numpy(rng.uniform(
            -3.0, 5.0, size=(nr, 3)).astype(np.float32)).to(dev)
        for nr in BOX_EDGES}}
    out = []
    for label, bpos in clouds.items():
        want = S.make_body_box_plain(bpos, h)
        call = functools.partial(S.make_body_box, bpos, h)
        out.append(Entry(label, "body_box", call,
                         lambda call=call, want=want:
                         0.0 if torch.equal(call(), want) else float("inf")))
    bpos = x["table"].pos
    return out + [Entry("box_plain", None,
                        functools.partial(S.make_body_box_plain, bpos, h),
                        lambda: 0.0)]


def body_walks(res: dict, case: str) -> None:
    """The body's walk of each source and form of --kernel pcisph_body:
    its call less its call without the body, by events and by the device
    time of all the call's kernels (a source may walk the body in a
    launch of its own)."""
    for key, stat in (("ms", "median"), ("call_device_us", None)):
        found = res.get(f"{key}_{case}", {})
        for label, _ in BODY_FORMS:
            for sfx in ("", "_ungated"):
                for src in sorted({k.split("/")[0] for k in found}):
                    got = [found.get(f"{src}/{label}{end}")
                           for end in (sfx, "_nobody")]
                    if None in got:
                        continue
                    a, b = ((t[stat] if stat else t) for t in got)
                    us = (a - b) * (1e3 if key == "ms" else 1.0)
                    res.setdefault(f"body_walk_{key}_{case}", {})[
                        f"{src}/{label}{sfx}"] = us
                    print(f"[{case}] {src:10s} the body's walk, "
                          f"{label}{sfx or ' gated'}: {us:.2f} us "
                          f"({'events' if key == 'ms' else 'device'})")


def cells(kernel: str) -> list[tuple[str, Callable, bool]]:
    """(case, inputs, timed with events) in the order they run: the 1M
    inputs, then the contraction's ragged engines (checked only), the
    half-immersed torus (rigid_side, rigid_gate) or the clustered cloud,
    then 30k."""
    if kernel in ("rigid_side", "rigid_gate", "pcisph_body", "body_box"):
        return [("1m", lambda: inputs.body_inputs("breaking_dam_1m.json",
                                                  3), True),
                ("torus", lambda: inputs.torus_inputs(3), True),
                ("30k", lambda: inputs.body_inputs("breaking_dam_30k.json",
                                                   3), False)]
    cloud = [] if kernel == "coef_matvec" else [
        ("clustered", lambda: inputs.clustered_inputs(CLUSTERED_N, seed=5),
         True)]
    return [("1m", lambda: inputs.lattice_inputs("breaking_dam_1m.json",
                                                 seed=7), True),
            *cloud,
            ("30k", lambda: inputs.lattice_inputs("breaking_dam_30k.json",
                                                  seed=7), False)]


def run_checks(res: dict, libs: dict, case: str, ents: list[Entry],
               bit_equal: str | None = None) -> None:
    """Every entry of every library against the plain version and, with
    `bit_equal`, against that library's outputs bit for bit."""
    for ent in ents:
        if bit_equal:
            with using(libs[bit_equal]):
                ref = ent.outputs(ent.call())
            for name, lib in libs.items():
                with using(lib):
                    got = ent.outputs(ent.call())
                diff = sum(int((a != b).sum()) for a, b in zip(got, ref))
                key = f"{name}/{case}/{ent.label}"
                res.setdefault("bit_diff", {})[key] = diff
                print(f"[bits] {key}: {diff} elements differ from "
                      f"{bit_equal}'s")
        for name, lib in libs.items():
            with using(lib):
                err = ent.check()
            key = f"{name}/{case}/{ent.label}"
            res["check"][key] = err
            print(f"[check] {key}: error / scale {err:.3e} "
                  f"{'ok' if err <= TOL else 'FAIL'}")


def time_rounds(res: dict, libs: dict, case: str,
                ents: list[Entry]) -> None:
    """CUDA events around batches of calls, sources in alternating order."""
    names = list(libs)
    for ent in ents:
        times: dict = {name: [] for name in names}
        for r in range(ROUNDS):
            for name in (names if r % 2 == 0 else names[::-1]):
                with using(libs[name]):
                    times[name].append(timing.batch_ms(ent.call))
        for name in names:
            ms = statistics.median(times[name])
            res.setdefault(f"ms_{case}", {})[f"{name}/{ent.label}"] = dict(
                median=ms, rounds=times[name])
            print(f"[{case}] {name:10s} {ent.label:20s} {ms * 1e3:9.2f} us "
                  f"(rounds {[round(t * 1e3, 2) for t in times[name]]})")


def library_us(fn, launches: int = 20) -> tuple[float, float]:
    """Device us a call of the library call `fn`, all its kernels (after 3
    calls outside the profile), twice: as `timing.device_us` returns."""
    for _ in range(3):
        fn()
    found, _ = timing.profile_kernels(lambda: [fn() for _ in range(launches)])
    us = sum(t for _, t in found.values()) / launches
    return us, us


def device_times(res: dict, libs: dict, case: str,
                 ents: list[Entry]) -> None:
    """torch.profiler's device time per launch: what a kernel takes where
    a call's host work outlasts it and sets the event time; and of all the
    kernels of a call."""
    for ent in ents:
        for name, lib in libs.items():
            with using(lib):
                us, call_us = (library_us(ent.call) if ent.kernel is None
                               else timing.device_us(ent.call, ent.kernel))
            key = f"{name}/{ent.label}"
            res.setdefault(f"device_us_{case}", {})[key] = us
            res.setdefault(f"call_device_us_{case}", {})[key] = call_us
            print(f"[{case}] {name:10s} {ent.label:20s} {us:9.2f} us on the "
                  f"device ({call_us:.2f} us the whole call)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES),
                    default="coef_matvec")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH", help="another source of the kernel")
    ap.add_argument("--bit-equal", default=None, metavar="NAME",
                    help="also compare every output bit for bit with "
                         "variant NAME's")
    ap.add_argument("--out", default=None,
                    help="JSON output (default build/perf/compare_<kernel>"
                         ".json)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    kernel = args.kernel
    sources = {"tree": _build._CSRC,
               **dict(v.split("=", 1) for v in args.variant)}
    print(f"[compare] {kernel} on card: {timing.card()}")
    libs = build_variants(kernel, sources)
    for name, lib in libs.items():
        regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
        print(f"[compare] {name}: {regs}")
        if kernel == "pcisph_body" and hasattr(lib.lib,
                                               "pcisph_predict_attributes"):
            with using(lib):
                build = S.body_walk_build()
            print(f"[compare] {name}: chunk {build['chunk']}; " + "; ".join(
                f"{form} {b}" for form, b in build.items()
                if isinstance(b, dict)))
    res: dict = {"card": timing.card(), "kernel": kernel, "check": {}}
    if args.bit_equal and args.bit_equal not in libs:
        raise SystemExit(f"--bit-equal {args.bit_equal}: no such source")

    for case, make, timed in cells(kernel):
        ents = entries(kernel, make())
        run_checks(res, libs, case, ents, args.bit_equal)
        if timed:
            time_rounds(res, libs, case, ents)
        device_times(res, libs, case, ents)
        if kernel == "pcisph_body":
            body_walks(res, case)
        del ents
        torch.cuda.empty_cache()
        if case == "1m" and kernel == "coef_matvec":
            for n in (1000, 1003):
                # One seed: the same rows, sources, pos, k and v in both
                # dtypes.
                rag = {d: inputs.ragged_engine(n, dt)
                       for d, dt in DTYPES.items()}
                run_checks(res, libs, f"ragged{n}", contraction_entries(
                    {d: r[0] for d, r in rag.items()}, *rag["f32"][1:]))
    bad = [key for key, err in res["check"].items() if not err <= TOL]
    bad += [f"bits:{key}" for key, diff in res.get("bit_diff", {}).items()
            if diff and key.startswith("tree/")]
    out = Path(args.out or f"build/perf/compare_{kernel}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"[compare] failed checks: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
