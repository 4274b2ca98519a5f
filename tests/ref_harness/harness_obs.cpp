// Observables / orbit / iono A/B harness: drives the *reference
// simulator's own* satpos, computeRange, computeCodePhase,
// checkSatVisibility and ionosphericDelay (compiled unmodified from the
// upstream checkout's src/geodesy.cpp, gal-sig.cpp, gnss-time.cpp,
// iono.cpp) to emit golden values for
// arbitrary ephemerides, epochs and receiver positions.  Output is consumed
// by tools/gen_obs_fixture.py to produce tests/data/obs_ref_fixture.json and
// tests/data/iono_ref_fixture.json, which tests/test_obs_ref_ab.py and
// tests/test_iono_ref_ab.py diff against this repo's geodesy.py /
// observables.py / iono.py to float64 precision.  The sample hot loop
// has its own harness, hotloop.cpp.
//
// Only this file is ours; the code under test is the reference's.  Build:
//   g++ -O1 -I tests/ref_harness/shim -I $GALILEO_UPSTREAM_DIR/include harness_obs.cpp \
//       $GALILEO_UPSTREAM_DIR/src/geodesy.cpp $GALILEO_UPSTREAM_DIR/src/gal-sig.cpp \
//       $GALILEO_UPSTREAM_DIR/src/gnss-time.cpp $GALILEO_UPSTREAM_DIR/src/iono.cpp
//
// Protocol (stdin, one command per line; all outputs printed with %.17g):
//   <ephkey> <value>          set an ephemeris/iono field (structures.h names)
//   derive                    fill A, n, sq1e2, omgkdot as rinex.cpp:225-229
//   satpos <week> <sec>                     -> "satpos px py pz vx vy vz c0 c1"
//   range <week> <sec> <x> <y> <z>          -> "range prange d az el iono"
//   codephase <w> <s0> <x0> <y0> <z0> <s1> <x1> <y1> <z1>
//                    -> "codephase f_carr f_code code_phase ibit ipage"
//   vis <week> <sec> <x> <y> <z> <mask_deg> -> "vis flag az el"
//   iono <week> <sec> <ulat> <ulon> <uh> <slat> <slon> <sh> <az> <el>
//        (angles rad, heights m)            -> "iono delay"

#include "galileo-sdr.h"  // upstream include/, on the -I path

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <sstream>
#include <string>

// referenced by galileo-sdr.h declarations but unused here
void sigint_handler(int) {}

static ephem_t eph;
static ionoutc_t ion;

int main() {
    memset(&eph, 0, sizeof(eph));
    memset(&ion, 0, sizeof(ion));
    eph.vflg = 1;

    std::map<std::string, double *> ed = {
        {"toe_sec", &eph.toe.sec}, {"toc_sec", &eph.toc.sec},
        {"deltan", &eph.deltan},   {"cuc", &eph.cuc},
        {"cus", &eph.cus},         {"cic", &eph.cic},
        {"cis", &eph.cis},         {"crc", &eph.crc},
        {"crs", &eph.crs},         {"ecc", &eph.ecc},
        {"sqrta", &eph.sqrta},     {"m0", &eph.m0},
        {"omg0", &eph.omg0},       {"inc0", &eph.inc0},
        {"aop", &eph.aop},         {"omgdot", &eph.omgdot},
        {"idot", &eph.idot},       {"af0", &eph.af0},
        {"af1", &eph.af1},         {"af2", &eph.af2},
        {"bgde5a", &eph.bgde5a},   {"bgde5b", &eph.bgde5b},
        {"ai0", &ion.ai0},         {"ai1", &ion.ai1},
        {"ai2", &ion.ai2},
    };

    std::string line;
    while (std::getline(std::cin, line)) {
        std::istringstream ss(line);
        std::string key;
        ss >> key;
        if (key.empty() || key[0] == '#') continue;
        if (key == "derive") {
            // rinex.cpp:225-229 (the reference's own derivation)
            eph.A = eph.sqrta * eph.sqrta;
            eph.n = WGS_SQRT_GM / (eph.sqrta * eph.A) + eph.deltan;
            eph.sq1e2 = sqrt(1.0 - eph.ecc * eph.ecc);
            eph.omg_t = eph.omg0 - OMEGA_EARTH * eph.toe.sec;
            eph.omgkdot = eph.omgdot - OMEGA_EARTH;
        } else if (key == "satpos") {
            galtime_t g; ss >> g.week >> g.sec;
            double pos[3], vel[3], clk[2];
            satpos(eph, g, pos, vel, clk);
            printf("satpos %.17g %.17g %.17g %.17g %.17g %.17g %.17g %.17g\n",
                   pos[0], pos[1], pos[2], vel[0], vel[1], vel[2], clk[0], clk[1]);
        } else if (key == "range") {
            galtime_t g; double xyz[3];
            ss >> g.week >> g.sec >> xyz[0] >> xyz[1] >> xyz[2];
            range_t rho; memset(&rho, 0, sizeof(rho));
            computeRange(&rho, eph, &ion, g, xyz, eph.svid);
            printf("range %.17g %.17g %.17g %.17g %.17g\n",
                   rho.range, rho.d, rho.azel[0], rho.azel[1], rho.iono_delay);
        } else if (key == "codephase") {
            galtime_t g0, g1; double xyz0[3], xyz1[3];
            ss >> g0.week >> g0.sec >> xyz0[0] >> xyz0[1] >> xyz0[2]
               >> g1.sec >> xyz1[0] >> xyz1[1] >> xyz1[2];
            g1.week = g0.week;
            range_t rho0, rho1;
            memset(&rho0, 0, sizeof(rho0)); memset(&rho1, 0, sizeof(rho1));
            computeRange(&rho0, eph, &ion, g0, xyz0, eph.svid);
            computeRange(&rho1, eph, &ion, g1, xyz1, eph.svid);
            channel_t chan; memset(&chan, 0, sizeof(chan));
            chan.rho0 = rho0;
            computeCodePhase(&chan, rho1, g1.sec - g0.sec, g1);
            printf("codephase %.17g %.17g %.17g %d %d\n",
                   chan.f_carr, chan.f_code, chan.code_phase, chan.ibit, chan.ipage);
        } else if (key == "vis") {
            galtime_t g; double xyz[3], mask, azel[2] = {0, 0};
            ss >> g.week >> g.sec >> xyz[0] >> xyz[1] >> xyz[2] >> mask;
            int v = checkSatVisibility(eph, g, xyz, mask, azel, eph.svid);
            printf("vis %d %.17g %.17g\n", v, azel[0], azel[1]);
        } else if (key == "iono") {
            galtime_t g; double ullh[3], sllh[3], azel[2];
            ss >> g.week >> g.sec >> ullh[0] >> ullh[1] >> ullh[2]
               >> sllh[0] >> sllh[1] >> sllh[2] >> azel[0] >> azel[1];
            double d = ionosphericDelay(&ion, g, ullh, sllh, azel, CARR_FREQ);
            printf("iono %.17g\n", d);
        } else if (key == "enable") {
            double v; ss >> v; ion.enable = (int)v;
        } else if (key == "vflg_ion") {
            double v; ss >> v; ion.vflg = (int)v;
        } else if (key == "svid") {
            double v; ss >> v; eph.svid = (int)v;
        } else if (ed.count(key)) {
            ss >> *ed[key];
        } else {
            fprintf(stderr, "unknown key: %s\n", key.c_str());
            return 2;
        }
    }
    return 0;
}
