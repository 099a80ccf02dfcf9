#!/usr/bin/env python3
"""Export the circuit netlists as ngspice .cir decks (the SPICE oracle),
from the PyTorch port's circuit builders.

The counterpart of `tools/export_spice.py`: the same 36 decks, the
netlists from `openwurli_tpu_torch/circuits/*.py` and the expected
values from the port's own solvers (`circuits/mna.dc_solve`, the GP
linearisation of `circuits/gp.py`), written into the directory `--out`
names (required: the committed decks under `spice/` are not overwritten
by default):

    python tools/torch_export_spice.py --out DIR
    ngspice -b DIR/tb_preamp_dc.cir   # compare .op against dc_solve

Everything runs on the CPU (NumPy and float64 torch); no kernel is
involved.
"""

import argparse
import math
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from openwurli_tpu_torch.circuits import gp, mna  # noqa: E402
from openwurli_tpu_torch.circuits import melange_preamp  # noqa: E402
from openwurli_tpu_torch.circuits import power_amp, tremolo  # noqa: E402


def _fmt(v):
    return f"{v:.6g}"


def _prefix_lines(lines, prefix):
    """Namespace a deck's device lines so two subcircuits coexist.

    Renames only true NODE tokens per device type (R/C/L/D/V/I/B: fields
    1-2; Q: 1-3) and v(node) references inside behavioral expressions —
    values, DC keywords, and model names are untouched.
    """
    node_counts = {"R": 2, "C": 2, "L": 2, "D": 2, "V": 2, "I": 2,
                   "B": 2, "Q": 3}

    def ren_expr(tok):
        return re.sub(
            r"v\((\w+)\)",
            lambda m: ("v(0)" if m.group(1) == "0"
                       else f"v({prefix}{m.group(1)})"), tok)

    out = []
    for line in lines:
        parts = line.split()
        if not parts or line.startswith(("*", ".", "+")):
            out.append(line)
            continue
        dev = parts[0][0].upper()
        if dev not in node_counts:
            out.append(line)
            continue
        n = node_counts[dev]
        new = [parts[0] + prefix.upper()]
        for i, p in enumerate(parts[1:], start=1):
            if i <= n and p != "0" and "(" not in p and "=" not in p:
                new.append(prefix + p)
            else:
                new.append(ren_expr(p))
        out.append(" ".join(new))
    return out


def netlist_to_cir(nl, title, tb_lines=()):
    names = {v: k for k, v in nl._nodes.items()}

    def node(n):
        return "0" if n < 0 else names[n]

    lines = [f"* {title}", "* exported from openwurli_tpu circuit builders"]
    models = {}
    for i, (n1, n2, r) in enumerate(nl.resistors):
        lines.append(f"R{i+1} {node(n1)} {node(n2)} {_fmt(r)}")
    for i, (n1, n2, c) in enumerate(nl.capacitors):
        lines.append(f"C{i+1} {node(n1)} {node(n2)} {_fmt(c)}")
    for name, np_, nm_, v in nl.vsources:
        lines.append(f"V{name[1:] if name.startswith('V') else name} "
                     f"{node(np_)} {node(nm_)} DC {_fmt(v)}")
    for name, nc, nb, ne, model, sign in nl.bjts:
        mtype = "PNP" if sign < 0 else "NPN"
        mname = f"Q{mtype}{abs(hash((model.is_, model.bf))) % 10000}"
        if mname not in models:
            parts = [f"IS={_fmt(model.is_)}", f"BF={_fmt(model.bf)}",
                     f"NF={_fmt(model.nf)}", f"BR={_fmt(model.br)}",
                     f"NR={_fmt(model.nr)}"]
            if math.isfinite(model.vaf):
                parts.append(f"VAF={_fmt(model.vaf)}")
            if math.isfinite(model.var):
                parts.append(f"VAR={_fmt(model.var)}")
            if math.isfinite(model.ikf):
                parts.append(f"IKF={_fmt(model.ikf)}")
            if math.isfinite(model.ikr):
                parts.append(f"IKR={_fmt(model.ikr)}")
            if model.ise:
                parts += [f"ISE={_fmt(model.ise)}", f"NE={_fmt(model.ne)}"]
            if model.isc:
                parts += [f"ISC={_fmt(model.isc)}", f"NC={_fmt(model.nc)}"]
            if model.cje:
                parts.append(f"CJE={_fmt(model.cje)}")
            if model.cjc:
                parts.append(f"CJC={_fmt(model.cjc)}")
            models[mname] = f".model {mname} {mtype}({' '.join(parts)})"
        lines.append(f"{name} {node(nc)} {node(nb)} {node(ne)} {mname}")
    for name, np_, nm_, model in nl.diodes:
        mname = f"D{abs(hash((model.is_, model.n))) % 10000}"
        if mname not in models:
            models[mname] = (f".model {mname} D(IS={_fmt(model.is_)} "
                             f"N={_fmt(model.n)})")
        lines.append(f"{name} {node(np_)} {node(nm_)} {mname}")
    lines.extend(models.values())
    lines.extend(tb_lines)
    lines.append(".end")
    return "\n".join(lines) + "\n"


def dc_expect(nl):
    """(v_dc, node names) of `nl`'s DC operating point."""
    v_dc, _, _ = mna.dc_solve(nl)
    return v_dc, list(nl._nodes)


def ac_gain(nl, v_nl_dc, freqs, out_node, extra_g=None):
    """Small-signal |H| from the GP linearisation at the DC OP."""
    asm = nl.assemble()
    jdev = gp.analytic_device_jacobian_fn(nl)(
        torch.as_tensor(np.asarray(v_nl_dc, np.float64))).numpy()
    g_lin = asm["g"] + asm["n_i"] @ jdev @ asm["n_v"]
    if extra_g:
        for node_idx, gval in extra_g:
            g_lin[node_idx, node_idx] += gval
    out = nl._nodes[out_node]
    gains = []
    for f in freqs:
        a = g_lin + 2j * np.pi * f * asm["c"]
        rhs = np.zeros(asm["n"], dtype=complex)
        rhs[asm["input_row"]] = 1.0
        x = np.linalg.solve(a, rhs)
        gains.append(abs(x[out]))
    return gains


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True,
                   help="directory for the decks (made if missing)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    decks = {
        "wurli-preamp.cir": (melange_preamp.build_netlist(),
                             "Wurlitzer 200A Reed-Bar Preamp",
                             [".op", ".print op all"]),
        "wurli-tremolo.cir": (tremolo.build_netlist(),
                              "Wurlitzer 200A Tremolo Oscillator (Twin-T)",
                              [".tran 0.1m 4 0 0.1m", ".print tran v(out)"]),
        "wurli-power-amp.cir": (power_amp.build_netlist(),
                                "Wurlitzer 200A Power Amplifier (Class AB)",
                                [".op"]),
    }
    for fname, (nl, title, tb) in decks.items():
        path = os.path.join(args.out, fname)
        with open(path, "w") as f:
            f.write(netlist_to_cir(nl, title, tb))
        print(f"wrote {path}")

    # ── testbench decks with expected values from our own solvers ──
    # (the reference ships 30 tb_*.cir oracle decks, spice/testbench/;
    # these regenerable decks cover the same roles: DC bias, AC gain,
    # THD, LDR sweeps, tremolo oscillation, pump family, full chain.)
    def write(fname, text):
        path = os.path.join(args.out, fname)
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path}")

    # 1. tremolo DC bias
    nl = tremolo.build_netlist()
    v_dc, names = dc_expect(nl)
    write("tb_tremolo_dc.cir", netlist_to_cir(
        nl, "Tremolo DC bias verification",
        [f"* expected (openwurli_tpu dc_solve): "
         f"{', '.join(f'{n}={v_dc[i]:.4f}' for i, n in enumerate(names))}",
         ".op"]))

    # 2. tremolo oscillator startup (rate + swing expectations)
    write("tb_tremolo_osc.cir", netlist_to_cir(
        nl, "Twin-T tremolo oscillator startup",
        ["* expected: oscillation builds from the unstable DC point;",
         "* rate 5.3-5.6 Hz, steady swing ~0.7-11.0 V at out",
         "* (reference gate band 4.5-7.5 Hz, dk_preamp/mod.rs:243-327)",
         ".ic v(out)=11.2", ".tran 0.2m 4 0 0.2m",
         ".print tran v(out)"]))

    # 3. preamp DC bias (LDR branch at its 1 MOhm quiescent)
    nlp = melange_preamp.build_netlist()
    nlp_dc = melange_preamp.build_netlist()
    nlp_dc.r("fb", "0", melange_preamp.R_LDR_INIT)
    v_dc, names = dc_expect(nlp_dc)
    write("tb_preamp_dc.cir", netlist_to_cir(
        nlp_dc, "Preamp DC bias verification (R_ldr = 1 MEG)",
        [f"* expected (openwurli_tpu dc_solve): "
         f"{', '.join(f'{n}={v_dc[i]:.4f}' for i, n in enumerate(names))}",
         ".op"]))

    # 4. preamp DC bias vs R_ldr
    lines = []
    for r in (19e3, 100e3, 1e6):
        nl_r = melange_preamp.build_netlist()
        nl_r.r("fb", "0", r)
        v_dc, names = dc_expect(nl_r)
        lines.append(f"* R_ldr={r:.0f}: "
                     + ", ".join(f"{n}={v_dc[i]:.4f}"
                                 for i, n in enumerate(names)
                                 if n in ("base1", "coll1", "coll2",
                                          "out", "fb")))
    nl_r = melange_preamp.build_netlist()
    nl_r.r("fb", "0", 100e3)
    write("tb_preamp_dc_vs_rldr.cir", netlist_to_cir(
        nl_r, "Preamp DC bias vs LDR resistance (deck at 100k; edit R_ldr)",
        lines + [".op"]))

    # 5. preamp AC gain (small-signal linearisation expectations)
    solver_pp = melange_preamp.make_params(88200.0)
    v_nl_dc = np.asarray(solver_pp.solver.v_nl_dc)
    fb_idx = nlp._nodes["fb"]
    freqs = [100.0, 1000.0, 5000.0, 15000.0]
    gains = ac_gain(nlp, v_nl_dc, freqs, "out",
                    extra_g=[(fb_idx, 1.0 / 1e6)])
    nlp_ac = melange_preamp.build_netlist()
    nlp_ac.r("fb", "0", 1e6)
    write("tb_preamp_ac.cir", netlist_to_cir(
        nlp_ac, "Preamp AC response (R_ldr = 1 MEG)",
        ["* expected |H| (openwurli_tpu GP linearisation at DC OP):"]
        + [f"*   {f:.0f} Hz: {g:.3f}x ({20*np.log10(g):.2f} dB)"
           for f, g in zip(freqs, gains)]
        + ["* reference: ~15 dB closed-loop midband (tb_preamp_ac.cir),"
           "* bandwidth ~15.5 kHz approx. independent of R_ldr",
           "VIN in 0 AC 1", ".ac dec 20 10 100k",
           ".print ac vdb(out)"]))

    # 6. preamp AC gain across the LDR sweep
    lines = ["* expected midband (1 kHz) gain vs R_ldr:"]
    for r in (9e3, 19e3, 56e3, 150e3, 1e6):
        g1k = ac_gain(nlp, v_nl_dc, [1000.0], "out",
                      extra_g=[(fb_idx, 1.0 / r)])[0]
        lines.append(f"*   R_ldr={r:9.0f}: {20*np.log10(g1k):6.2f} dB")
    write("tb_preamp_ac_sweep_ldr.cir", netlist_to_cir(
        nlp_ac, "Preamp gain vs LDR (deck at 1 MEG; edit R_ldr)",
        lines + ["VIN in 0 AC 1", ".ac lin 1 1000 1000",
                 ".print ac vdb(out)"]))

    # 7. preamp THD (transient oracle)
    write("tb_real_thd.cir", netlist_to_cir(
        nlp_ac, "Preamp THD at 1 kHz, 1 mV drive",
        ["* expected (openwurli_tpu circuits/dk_preamp +"
         " melange variant agree to 0.45 dB):",
         "* THD(H2-H5) ~ small-signal 0.001-0.01 % at 1 mV;"
         " H2 dominates (single-ended stages)",
         "VIN in 0 SIN(0 1m 1k)", ".tran 5u 50m 30m 5u",
         ".fourier 1k v(out)"]))

    # 8. power amp DC bias
    nlpa = power_amp.build_netlist()
    v_dc, names = dc_expect(nlpa)
    write("tb_power_amp.cir", netlist_to_cir(
        nlpa, "Class AB power amp DC bias",
        [f"* expected (openwurli_tpu dc_solve): "
         f"{', '.join(f'{n}={v_dc[i]:.4f}' for i, n in enumerate(names))}",
         ".op"]))

    # 9. power amp closed-loop gain
    pa_solver = power_amp.make_params(88200.0)
    v_nl_pa = np.asarray(pa_solver.solver.v_nl_dc)
    g_pa = ac_gain(nlpa, v_nl_pa, [1000.0], "out")[0]
    write("tb_power_amp_gain.cir", netlist_to_cir(
        nlpa, "Class AB closed-loop gain",
        [f"* expected |H(1 kHz)| = {g_pa:.2f}x "
         f"({20*np.log10(g_pa):.2f} dB; feedback 1+15000/220 = 69.2x)",
         "VIN in 0 AC 1", ".ac lin 1 1000 1000", ".print ac v(out)"]))

    # 10. pickup time-varying RC (behavioral stage as a B-source deck)
    write("tb_pickup.cir", "\n".join([
        "* Electrostatic pickup: 1/(1-y) time-varying RC",
        "* (crates/openwurli-dsp/src/pickup.rs topology; our",
        "* openwurli_tpu/pickup.py is the bilinear discretisation)",
        "* expected: HPF corner 2312 Hz (tau = 287k x 240p);",
        "* output sensitivity 1.8375 V; H2 > H3 (asymmetric 1/(1-y))",
        "VY y 0 SIN(0 0.3 220)",
        "BC q 0 V = v(chg)*(1 - v(y))",
        "RQ chg q 287k",
        "CQ chg 0 240p",
        "* (simplified linearised deck; full behavior in pickup.py tests)",
        ".tran 10u 50m",
        ".end", ""]))

    # 11. pump family: shadow-pump step response
    write("tb_preamp_pump_transient.cir", netlist_to_cir(
        nlp_ac, "Tremolo pump: R_ldr step response (zero audio input)",
        ["* expected: OUT DC shifts with the fb divider as R_ldr steps;",
         "* pp pump bounded (~0.2 V at mid-R per cli pump-sweep; decays",
         "* with tau ~ Ce1*(R10+R_ldr))",
         "VIN in 0 DC 0", ".tran 0.1m 1.5", ".print tran v(out)"]))

    # 12. full chain: preamp -> 0.25 drive -> power amp
    chain = netlist_to_cir(nlp_ac, "chain-preamp", []).splitlines()
    chain = [l for l in chain if l not in (".end",)]
    pa_lines = netlist_to_cir(nlpa, "chain-pa", []).splitlines()[2:]
    pa_lines = [l for l in pa_lines if l != ".end"]
    renamed = _prefix_lines(pa_lines, "pa_")
    write("tb_full_chain.cir", "\n".join(
        chain
        + ["* drive: preamp out x 0.25 into the power amp input",
           "BDRV pa_in 0 V = 0.25*v(out)"]
        + renamed
        + ["* expected: end-to-end ~14 dB (preamp, tremolo off) + 36.8 dB",
           "* (power amp) - 12 dB drive = system gain before speaker",
           "VIN in 0 SIN(0 1m 1k)", ".tran 5u 30m", ".end", ""]))

    _write_extended_benches(write, nlp_ac, v_nl_dc, fb_idx, nlp)


def _write_extended_benches(write, nlp_ac, v_nl_dc, fb_idx, nlp):
    """Testbench families 13+ — parity with the Rust reference's 30-deck
    suite (its spice/testbench/). Expected values cite BOTH our
    solvers and the reference's own documented numbers (schematic
    annotations, gate bands), so the oracle is not purely self-referential.
    """
    # 13. verify_dc_bias: schematic-annotation cross-check
    nl_dc = melange_preamp.build_netlist()
    nl_dc.r("fb", "0", melange_preamp.R_LDR_INIT)
    v_dc, names = dc_expect(nl_dc)
    ours = {n: v_dc[i] for i, n in enumerate(names)}
    write("verify_dc_bias.cir", netlist_to_cir(
        nl_dc, "Comprehensive DC bias verification vs schematic",
        ["* Schematic #203720-S-3 annotations (reference "
         "verify_dc_bias.cir:4-7):",
         "*   TR-1: Vb=2.45 Ve=1.95 Vc=4.1  (Vbe=0.50, Vce=2.15)",
         "*   TR-2: Vb=4.1  Ve=3.4  Vc=8.8  (Vbe=0.70, Vce=5.4)",
         "* ours (dc_solve): "
         + ", ".join(f"{n}={ours[n]:.3f}" for n in names
                     if n in ("base1", "emit1", "coll1", "emit2",
                              "coll2", "out", "fb")),
         ".op"]))

    # 14. DK validation: ideal-beta simplification at both LDR endpoints
    for tag, r_ldr in (("1meg", 1e6), ("19k", 19e3)):
        nl_i = melange_preamp.build_netlist()
        nl_i.r("fb", "0", r_ldr)
        v_dc, names = dc_expect(nl_i)
        write(f"tb_dk_validation_{tag}.cir", netlist_to_cir(
            nl_i, f"DK preamp validation (R_ldr={tag})",
            ["* role of reference tb_dk_validation.cir: compare DC OP and",
             "* AC gain against the 8-node DK solver at both R_ldr",
             "* endpoints (no C20/D1/Rload simplification there; this",
             "* deck keeps the full netlist — cross-solver gate 2 dB,",
             "* dk_preamp/mod.rs:101-117)",
             "* ours (dc_solve): "
             + ", ".join(f"{n}={v_dc[i]:.3f}" for i, n in enumerate(names)
                         if n in ("base1", "coll1", "coll2", "out", "fb")),
             ".op"]))

    # 15. DK AC extraction: |H| table for the analytic 8x8 comparison
    freqs = [30.0, 100.0, 300.0, 1e3, 3e3, 10e3, 15.5e3, 30e3]
    gains = ac_gain(nlp, v_nl_dc, freqs, "out",
                    extra_g=[(fb_idx, 1.0 / 1e6)])
    write("tb_dk_ac_extract.cir", netlist_to_cir(
        nlp_ac, "DK AC extraction (R_ldr = 1 MEG)",
        ["* expected |H| (GP linearisation at DC OP) — the DK test",
         "* pyramid L4 builds the same curve from an independent",
         "* complex 8x8 solve (tests/test_dk_preamp.py):"]
        + [f"*   {f:8.0f} Hz: {20*np.log10(g):7.2f} dB"
           for f, g in zip(freqs, gains)]
        + ["* reference anchors: ~15 dB midband, -3 dB ~15.5 kHz,",
           "* bandwidth ~independent of R_ldr (preamp-circuit.md:521)",
           "VIN in 0 AC 1", ".ac dec 40 10 100k", ".print ac vdb(out)"]))

    # 16. DC transfer sweep (clipping asymmetry)
    write("tb_preamp_transfer.cir", netlist_to_cir(
        nlp_ac, "Preamp DC transfer (input sweep)",
        ["* expected: linear region slope ~= midband gain ("
         f"{20*np.log10(ac_gain(nlp, v_nl_dc, [1e3], 'out', extra_g=[(fb_idx, 1e-6)])[0]):.1f} dB);",
         "* asymmetric soft clip (single-ended stages -> H2-dominant)",
         "VIN in 0 DC 0", ".dc VIN -0.5 0.5 0.005",
         ".print dc v(out)"]))

    # 17-19. clipping / harmonic family at three drive levels
    for fname, amp_v, note in (
            ("tb_preamp_clipping.cir", "50m",
             "* expected: visible asymmetric clipping; H2 > H3"),
            ("tb_preamp_harmonic.cir", "10m",
             "* expected: THD ~0.79 % at chain-level drive (reference"
             " dk_preamp/mod.rs:7)"),
            ("tb_harmonic_audit.cir", "1m",
             "* expected: small-signal THD ~0.0004-0.01 %"
             " (preamp-circuit.md:846)")):
        write(fname, netlist_to_cir(
            nlp_ac, f"Preamp harmonic content at {amp_v} drive",
            [note, f"VIN in 0 SIN(0 {amp_v} 1k)",
             ".tran 5u 60m 40m 5u", ".fourier 1k v(out)"]))

    # 20-22. transient family
    write("tb_preamp_tran.cir", netlist_to_cir(
        nlp_ac, "Preamp transient (burst response)",
        ["* expected: no ringing; HF rolloff per the ~15.5 kHz bandwidth",
         "VIN in 0 SIN(0 5m 1k)", ".tran 2u 20m", ".print tran v(out)"]))
    write("tb_preamp_tran_analysis.cir", netlist_to_cir(
        nlp_ac, "Preamp step response / time constants",
        ["* expected: input HPF tau = Cin*(R1ish) — sub-ms edge, then",
         "* slow Ce1 recovery; settles to DC OP (see tb_preamp_dc.cir)",
         "VIN in 0 PULSE(0 10m 1m 1u 1u 8m 20m)", ".tran 2u 20m",
         ".print tran v(out)"]))
    write("preamp_transient.cir", netlist_to_cir(
        nlp_ac, "Preamp startup settle",
        ["* expected: output settles to the DC OP from zero initial",
         "* conditions within ~0.5 s (engine warm_up = 0.6 s,",
         "* engine.rs:261-270)",
         "VIN in 0 DC 0", ".tran 1m 1 0 1m", ".print tran v(out)"]))

    # 23. LDR transient sweep (transient analogue of the AC sweep)
    write("preamp_ldr_sweep.cir", netlist_to_cir(
        nlp, "Preamp output vs time-varying LDR (behavioral shunt)",
        ["* fb shunt swept 1 MEG -> 9 k as a behavioral conductance;",
         "* expected: gain rises as R_ldr falls; no clicks (the engine's",
         "* LDR-sweep click gate, dk_preamp/mod.rs:125-172)",
         "BLDR fb 0 I = v(fb)*(1u + 110u*(0.5+0.5*sin(6.2832*0.5*time)))",
         "VIN in 0 SIN(0 2m 1k)", ".tran 0.1m 2", ".print tran v(out)"]))

    # 24. R_ldr switching transient (pump step)
    write("tb_rldr_transient.cir", netlist_to_cir(
        nlp, "R_ldr step -> shadow-pump transient",
        ["* fb shunt steps 1 MEG -> 19 k at t=50 ms (zero audio);",
         "* expected: DC shift at out with pp pump ~0.2 V decaying with",
         "* tau ~ Ce1*(R10+R_ldr) (cli pump-step measures the same)",
         "BLDR fb 0 I = v(fb)*(1u + 51.6u*u(time-50m))",
         "VIN in 0 DC 0", ".tran 0.2m 0.5", ".print tran v(out)"]))

    # 25-27. pump detail family (node-level observations)
    for fname, probe, note in (
            ("tb_pump_c8_detail.cir", "v(emit1)",
             "* expected: Ce1 (emitter bypass) node charges toward the"
             " new OP; the pump's dominant time constant"),
            ("tb_pump_emit.cir", "v(emit2a)",
             "* expected: second-stage emitter follows with smaller"
             " excursion"),
            ("tb_pump_loaded.cir", "v(out)",
             "* expected: loading the output (100k volume pot) does not"
             " change the pump shape, only level")):
        nl_l = melange_preamp.build_netlist()
        extra = ["BLDR fb 0 I = v(fb)*(1u + 51.6u*u(time-50m))",
                 "VIN in 0 DC 0"]
        if fname == "tb_pump_loaded.cir":
            nl_l.r("out", "0", 100e3)
        write(fname, netlist_to_cir(
            nl_l, f"Pump family: {probe}",
            [note] + extra + [".tran 0.2m 0.5", f".print tran {probe}"]))

    # 28. pot DC effect: two preamp instances, with/without load
    base = netlist_to_cir(nlp_ac, "pot-effect", []).splitlines()
    base = [l for l in base if l != ".end" and not l.startswith("*")]
    inst_a = _prefix_lines(base, "a_")
    inst_b = [l for l in _prefix_lines(base + ["RPOT out 0 100k"], "b_")
              if not l.startswith(".model")]  # models shared with a_
    write("tb_pump_pot_effect.cir", "\n".join(
        ["* Volume-pot DC effect: instance a_ unloaded, b_ loaded 100k",
         "* expected: internal DC bias unchanged by the pot (reference",
         "* tb_pump_pot_effect.cir purpose line)"]
        + inst_a + inst_b
        + ["VINA a_in 0 DC 0", "VINB b_in 0 DC 0", ".op", ".end", ""]))

    # 29. tremolo register: dark vs bright instance, depth vs frequency
    dark = _prefix_lines(base, "d_")
    brt = [l for l in _prefix_lines(base, "b_")
           if not l.startswith(".model")]
    write("tb_tremolo_register.cir", "\n".join(
        ["* Tremolo modulation depth vs register: dark (R_ldr=1MEG) and",
         "* bright (19k) instances driven at one frequency; sweep the",
         "* source frequency 130/261/523/1046 Hz across runs.",
         "* expected: depth = gain(bright)-gain(dark) ~4-8 dB, roughly",
         "* CONSTANT across register (reference tb_tremolo_register.cir",
         "* purpose; engine gate band dk_preamp/mod.rs:232-241)"]
        + dark + brt
        + ["RLDRD d_fb 0 1meg", "RLDRB b_fb 0 19k",
           "VIND d_in 0 SIN(0 2m 523)", "VINB b_in 0 SIN(0 2m 523)",
           ".tran 5u 40m 20m 5u", ".print tran v(d_out) v(b_out)",
           ".end", ""]))

    # 30. variable GBW: gain from base1 (bypasses input attenuation)
    lines = ["* expected |v(out)/v(base1)| rises as R_ldr falls while the",
             "* -3 dB corner stays ~15.5 kHz => GBW grows with gain",
             "* (DK pyramid L4 asserts GBW ∝ gain; reference",
             "* tb_variable_gbw.cir investigates the same)"]
    for r in (1e6, 100e3, 19e3):
        g1k = ac_gain(nlp, v_nl_dc, [1e3], "out",
                      extra_g=[(fb_idx, 1.0 / r)])[0]
        lines.append(f"*   R_ldr={r:9.0f}: 1 kHz gain "
                     f"{20*np.log10(g1k):6.2f} dB")
    write("tb_variable_gbw.cir", netlist_to_cir(
        nlp_ac, "Variable gain-bandwidth diagnostic",
        lines + ["VIN in 0 AC 1", ".ac dec 20 100 100k",
                 ".print ac vdb(out) vdb(base1)"]))

    # 31. power supply / rail sag (behavioral RailDynamics model)
    write("tb_power_supply.cir", "\n".join([
        "* Power supply rail sag under load (RailDynamics behavioral",
        "* model, power_amp.rs:11-165 / circuits/power_amp.py)",
        f"* expected: idle ±{power_amp.RAIL_V_OPEN} V open-circuit,",
        f"* sagging toward ±22 V at full load through R_eff = "
        f"{power_amp.RAIL_R_EFF} Ω;",
        "* recovery tau ~30 ms (current envelope) + 8/15 ms asym rail",
        "VT vp_open 0 DC " + _fmt(power_amp.RAIL_V_OPEN),
        "RS vp_open vp " + _fmt(power_amp.RAIL_R_EFF),
        "CF vp 0 4700u",
        "* load step: 0 -> 2 A at t=100 ms",
        "BLOAD vp 0 I = 2*u(time-100m)",
        ".tran 1m 0.5", ".print tran v(vp)", ".end", ""]))

    # 32. tremolo pump: oscillator-driven LDR against the preamp
    write("tremolo_pump.cir", netlist_to_cir(
        nlp, "Tremolo pump: 5.5 Hz LDR modulation, zero audio",
        ["* fb shunt modulated at the Twin-T rate; expected: residual",
         "* pump at out bounded (engine idle-pump gate); main-shadow",
         "* subtraction in the DSP model cancels exactly this signal",
         "BLDR fb 0 I = v(fb)*(26u + 25u*sin(6.2832*5.5*time))",
         "VIN in 0 DC 0", ".tran 0.5m 1", ".print tran v(out)"]))


if __name__ == "__main__":
    main()
