// I/NAV A/B harness: drives the *reference simulator's own encoder*
// (compiled unmodified from $GALILEO_UPSTREAM_DIR/src/inav-msg.cpp +
// datatypes.cpp) to emit golden page pairs for arbitrary ephemerides and
// epochs.  Output is consumed by tools/gen_inav_fixture.py to produce
// tests/data/inav_ref_pages.json, which tests/test_inav_ref_ab.py diffs
// bit-for-bit against this repo's inav.py.
//
// Only this file is ours; the encoder under test is the reference's.
// Build (see tools/gen_inav_fixture.py):
//   g++ -O1 -I tests/ref_harness/shim -I $GALILEO_UPSTREAM_DIR/include harness.cpp \
//       $GALILEO_UPSTREAM_DIR/src/inav-msg.cpp $GALILEO_UPSTREAM_DIR/src/datatypes.cpp
//
// Protocol: stdin lines "key value" set ephemeris/iono fields (keys match
// structures.h names; "tow" lines emit one page for that epoch).

#include "galileo-sdr.h"  // upstream include/, on the -I path

#include <cstdio>
#include <cstring>
#include <map>
#include <sstream>
#include <string>

// referenced by galileo-sdr.h declarations but unused by the encoder
void sigint_handler(int) {}

int main() {
    ephem_t eph;
    ionoutc_t ion;
    memset(&eph, 0, sizeof(eph));
    memset(&ion, 0, sizeof(ion));
    galtime_t g;
    g.week = 0;
    g.sec = 0.0;

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
    };

    std::string line;
    while (std::getline(std::cin, line)) {
        std::istringstream ss(line);
        std::string key;
        ss >> key;
        if (key.empty() || key[0] == '#') continue;
        if (key == "tow") {
            double tow;
            ss >> tow;
            g.sec = tow;
            channel_t chan;
            memset(&chan, 0, sizeof(chan));
            generateINavMsg(g, &chan, &eph, &ion);
            printf("page %d %.3f ", g.week, tow);
            for (int i = 0; i < 500; i++) putchar('0' + (chan.page[i] & 1));
            putchar('\n');
            free(chan.page);
        } else if (key == "week") {
            ss >> g.week;
        } else if (key == "iode") {
            double v; ss >> v; eph.iode = (int)v;
        } else if (key == "svid") {
            double v; ss >> v; eph.svid = (int)v;
        } else if (key == "svhlth") {
            double v; ss >> v; eph.svhlth = (int)v;
        } else if (key == "ai0") { ss >> ion.ai0;
        } else if (key == "ai1") { ss >> ion.ai1;
        } else if (key == "ai2") { ss >> ion.ai2;
        } else if (key == "A0") { ss >> ion.A0;
        } else if (key == "A1") { ss >> ion.A1;
        } else if (key == "dtls") { double v; ss >> v; ion.dtls = (int)v;
        } else if (key == "tot") { double v; ss >> v; ion.tot = (int)v;
        } else if (key == "wnt") { double v; ss >> v; ion.wnt = (int)v;
        } else if (key == "wnlsf") { double v; ss >> v; ion.wnlsf = (int)v;
        } else if (key == "dn") { double v; ss >> v; ion.dn = (int)v;
        } else if (key == "dtlsf") { double v; ss >> v; ion.dtlsf = (int)v;
        } else if (ed.count(key)) {
            ss >> *ed[key];
        } else {
            fprintf(stderr, "unknown key: %s\n", key.c_str());
            return 2;
        }
    }
    return 0;
}
