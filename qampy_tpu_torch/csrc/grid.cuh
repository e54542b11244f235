// The constellation of a launch, shared by the phase searches (phase.cu: B3,
// B8) and the block trainer's decision methods (equaliser.cu: B1). The host
// side is ops/phase.py grid_consts: one function maps a grid spec to these
// fields for every launcher.
#pragma once

// The kinds of constellation (ops/phase.py KIND_CODE): square and rectangular
// grids decide per axis and share kRect.
enum GridKind { kRect = 0, kCross = 1, kGen = 2 };

// g0, g1: the lowest level of the real and of the imaginary axis. g2, g3:
// kRect the levels less one per axis (nr-1, ni-1); kCross (an n x n grid less
// its c x c corners) n-1 and c. d0: the level spacing. kGen: npts points,
// their (npts, 3) table [2 re, 2 im, |s|^2] in shared memory, no g.
// B1 gets d0, g0 and g1 in the alphabet's units. The searches fold 1/d0 into
// their rotation tables and work in units of the spacing: they get g0/d0,
// g1/d0 and d0 = 1.
struct GridArgs {
    int kind;
    float d0, g0, g1, g2, g3;
    int npts;
};
