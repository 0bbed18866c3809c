"""The port's front end against the JAX package's: the Cantera parsers
(CTI, YAML, CTML) and ``Mechanism.from_files``, the structural sparsity
and CSR export, the state utilities, the native state I/O, and the
command-line interface (archive, manifest, ``--validate``).

The numpy front end is copied, not shared (importing ``pyjac_tpu``
imports jax), so every comparison here is on equal inputs and asks for
equal outputs: arrays bit for bit, IR field for field.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import torch

from pyjac_tpu import cli as jcli
from pyjac_tpu import utils as jutils
from pyjac_tpu.core import ctml as jctml
from pyjac_tpu.core import ctyaml as jctyaml
from pyjac_tpu.core import cti as jcti
from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import load_packed as jload_packed
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.ops import sparse as jsparse
from pyjac_tpu.runtime import stateio as jstateio
from pyjac_tpu.testers import synthetic as jsynth
from pyjac_tpu_torch import cli, utils
from pyjac_tpu_torch.core import chemkin, ctml, ctyaml, cti
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import load_packed, pack
from pyjac_tpu_torch.ops import sparse
from pyjac_tpu_torch.ops.jacobian import eval_jacobian
from pyjac_tpu_torch.runtime import stateio
from pyjac_tpu_torch.testers import synthetic

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# one mechanism in four formats.  CHEMKIN and YAML are copies of
# tests/test_yaml.py's, CTML of tests/test_ctml.py's (thermo filled from
# the YAML species, A values pre-converted to kmol/m^3 as ctml_writer
# writes them); CTI is its twin in Cantera's Python DSL, with every
# reaction of the CTML document.  CHEMKIN holds the first three reactions,
# YAML the first five.
# ---------------------------------------------------------------------------

CHEMKIN = """ELEMENTS
H O N
END
SPECIES
AB CD EF N2
END
THERMO ALL
   300.000  1000.000  5000.000
AB                      H   2O   1          G    300.000  5000.000 1000.000    1
 3.10000000E+00 1.00000000E-03 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-1.00000000E+03 4.00000000E+00 2.90000000E+00 2.00000000E-03 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-9.00000000E+02 5.00000000E+00                   4
CD                      O   2               G    300.000  5000.000 1000.000    1
 3.50000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-2.00000000E+03 3.00000000E+00 3.40000000E+00 1.00000000E-03 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-1.90000000E+03 3.50000000E+00                   4
EF                      H   1O   2          G    300.000  5000.000 1000.000    1
 4.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-3.00000000E+03 2.00000000E+00 3.90000000E+00 5.00000000E-04 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-2.90000000E+03 2.50000000E+00                   4
N2                      N   2               G    300.000  5000.000 1000.000    1
 2.92000000E+00 1.50000000E-03 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-9.20000000E+02 5.98000000E+00 3.30000000E+00 1.40000000E-03 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-1.02000000E+03 3.95000000E+00                   4
END
REACTIONS
AB+CD<=>EF               1.500E+13    0.500     2000.00
AB+AB+M<=>CD+M           2.000E+16   -1.000        0.00
EF/5.0/ N2/0.5/
AB+EF(+M)<=>CD+CD(+M)    7.400E+13   -0.370        0.00
LOW / 2.300E+18 -0.900 -1700.00 /
TROE / 0.7346 94.00 1756.00 5182.00 /
N2/0.7/
END
"""

YAML = """
units: {length: cm, time: s, quantity: mol, activation-energy: cal/mol}
phases:
- name: gas
  elements: [H, O, N]
  species: [AB, CD, EF, N2]
species:
- name: AB
  composition: {H: 2, O: 1}
  thermo:
    model: NASA7
    temperature-ranges: [300.0, 1000.0, 5000.0]
    data:
    - [2.9, 2.0e-03, 0.0, 0.0, 0.0, -900.0, 5.0]
    - [3.1, 1.0e-03, 0.0, 0.0, 0.0, -1000.0, 4.0]
- name: CD
  composition: {O: 2}
  thermo:
    model: NASA7
    temperature-ranges: [300.0, 1000.0, 5000.0]
    data:
    - [3.4, 1.0e-03, 0.0, 0.0, 0.0, -1900.0, 3.5]
    - [3.5, 0.0, 0.0, 0.0, 0.0, -2000.0, 3.0]
- name: EF
  composition: {H: 1, O: 2}
  thermo:
    model: NASA7
    temperature-ranges: [300.0, 1000.0, 5000.0]
    data:
    - [3.9, 5.0e-04, 0.0, 0.0, 0.0, -2900.0, 2.5]
    - [4.0, 0.0, 0.0, 0.0, 0.0, -3000.0, 2.0]
- name: N2
  composition: {N: 2}
  thermo:
    model: NASA7
    temperature-ranges: [300.0, 1000.0, 5000.0]
    data:
    - [3.3, 1.4e-03, 0.0, 0.0, 0.0, -1020.0, 3.95]
    - [2.92, 1.5e-03, 0.0, 0.0, 0.0, -920.0, 5.98]
reactions:
- equation: AB + CD <=> EF
  rate-constant: {A: 1.5e+13, b: 0.5, Ea: 2000.0}
- equation: AB + AB + M <=> CD + M
  type: three-body
  rate-constant: {A: 2.0e+16, b: -1.0, Ea: 0.0}
  efficiencies: {EF: 5.0, N2: 0.5}
- equation: AB + EF (+M) <=> CD + CD (+M)
  type: falloff
  high-P-rate-constant: {A: 7.4e+13, b: -0.37, Ea: 0.0}
  low-P-rate-constant: {A: 2.3e+18, b: -0.9, Ea: -1700.0}
  Troe: {A: 0.7346, T3: 94.0, T1: 1756.0, T2: 5182.0}
  efficiencies: {N2: 0.7}
- equation: AB + CD <=> EF + N2
  type: pressure-dependent-Arrhenius
  rate-constants:
  - {P: 0.1 atm, A: 1.0e+12, b: 0.0, Ea: 1000.0}
  - {P: 1.0 atm, A: 1.0e+13, b: 0.0, Ea: 900.0}
- equation: CD + EF <=> AB + N2
  type: Chebyshev
  temperature-range: [500.0, 3000.0]
  pressure-range: [0.01 atm, 100.0 atm]
  data:
  - [7.0, 0.1]
  - [0.05, -0.02]
"""

_TH = """<thermo>
  <NASA Tmin="300.0" Tmax="1000.0" P0="100000.0">
    <floatArray name="coeffs" size="7">{lo}</floatArray>
  </NASA>
  <NASA Tmin="1000.0" Tmax="5000.0" P0="100000.0">
    <floatArray name="coeffs" size="7">{hi}</floatArray>
  </NASA>
</thermo>"""

CTML = """<?xml version="1.0"?>
<ctml>
  <phase dim="3" id="gas">
    <elementArray datasrc="elements.xml">H O N</elementArray>
    <speciesArray datasrc="#species_data">AB CD EF N2</speciesArray>
    <reactionArray datasrc="#reaction_data"/>
  </phase>
  <speciesData id="species_data">
    <species name="AB"><atomArray>H:2 O:1 </atomArray>{AB}</species>
    <species name="CD"><atomArray>O:2 </atomArray>{CD}</species>
    <species name="EF"><atomArray>H:1 O:2 </atomArray>{EF}</species>
    <species name="N2"><atomArray>N:2 </atomArray>{N2}</species>
  </speciesData>
  <reactionData id="reaction_data">
    <reaction reversible="yes" id="0001">
      <equation>AB + CD [=] EF</equation>
      <rateCoeff><Arrhenius>
        <A>1.5e+10</A><b>0.5</b><E units="cal/mol">2000.0</E>
      </Arrhenius></rateCoeff>
      <reactants>AB:1.0 CD:1.0</reactants>
      <products>EF:1.0</products>
    </reaction>
    <reaction reversible="yes" type="threeBody" id="0002">
      <equation>2 AB + M [=] CD + M</equation>
      <rateCoeff>
        <Arrhenius><A>2.0e+10</A><b>-1.0</b>
          <E units="cal/mol">0.0</E></Arrhenius>
        <efficiencies default="1.0">EF:5.0 N2:0.5</efficiencies>
      </rateCoeff>
      <reactants>AB:2.0</reactants>
      <products>CD:1.0</products>
    </reaction>
    <reaction reversible="yes" type="falloff" id="0003">
      <equation>AB + EF (+ M) [=] 2 CD (+ M)</equation>
      <rateCoeff>
        <Arrhenius><A>7.4e+10</A><b>-0.37</b>
          <E units="cal/mol">0.0</E></Arrhenius>
        <Arrhenius name="k0"><A>2.3e+12</A><b>-0.9</b>
          <E units="cal/mol">-1700.0</E></Arrhenius>
        <falloff type="Troe">0.7346 94.0 1756.0 5182.0</falloff>
        <efficiencies default="1.0">N2:0.7</efficiencies>
      </rateCoeff>
      <reactants>AB:1.0 EF:1.0</reactants>
      <products>CD:2.0</products>
    </reaction>
    <reaction reversible="yes" type="plog" id="0004">
      <equation>AB + CD [=] EF + N2</equation>
      <rateCoeff>
        <Arrhenius><P units="atm">0.1</P><A>1.0e+9</A><b>0.0</b>
          <E units="cal/mol">1000.0</E></Arrhenius>
        <Arrhenius><P units="atm">1.0</P><A>1.0e+10</A><b>0.0</b>
          <E units="cal/mol">900.0</E></Arrhenius>
      </rateCoeff>
      <reactants>AB:1.0 CD:1.0</reactants>
      <products>EF:1.0 N2:1.0</products>
    </reaction>
    <reaction reversible="yes" type="chebyshev" id="0005">
      <equation>CD + EF [=] AB + N2</equation>
      <rateCoeff>
        <Tmin>500.0</Tmin><Tmax>3000.0</Tmax>
        <Pmin units="atm">0.01</Pmin><Pmax units="atm">100.0</Pmax>
        <floatArray name="coeffs" degreeT="2" degreeP="2">
          4.0, 0.1, 0.05, -0.02</floatArray>
      </rateCoeff>
      <reactants>CD:1.0 EF:1.0</reactants>
      <products>AB:1.0 N2:1.0</products>
    </reaction>
    <reaction reversible="no" type="chemAct" duplicate="yes" id="0006">
      <equation>AB + CD (+ N2) =] EF (+ N2)</equation>
      <rateCoeff>
        <Arrhenius><A>3.0e+10</A><b>0.0</b>
          <E units="cal/mol">100.0</E></Arrhenius>
        <Arrhenius name="kHigh"><A>6.0e+7</A><b>0.5</b>
          <E units="cal/mol">50.0</E></Arrhenius>
        <falloff type="SRI">0.54 201.0 1024.0</falloff>
      </rateCoeff>
      <reactants>AB:1.0 CD:1.0</reactants>
      <products>EF:1.0</products>
    </reaction>
  </reactionData>
</ctml>"""

# the CTI twin: mol / cm / cal/mol units, so the pre-exponentials are the
# YAML's (the reader converts them as the Chemkin reader does); the
# chemically activated high-pressure limit's A is the CTML's, since the
# reader converts it with the reaction's order less two (kmol/m^3 already)
CTI = """units(length='cm', time='s', quantity='mol', act_energy='cal/mol')

ideal_gas(name='gas', elements='H O N', species='AB CD EF N2',
          reactions='all',
          initial_state=state(temperature=300.0, pressure=OneAtm))

species(name='AB', atoms='H:2 O:1',
        thermo=(NASA([300.0, 1000.0], [{AB_lo}]),
                NASA([1000.0, 5000.0], [{AB_hi}])))
species(name='CD', atoms='O:2',
        thermo=(NASA([300.0, 1000.0], [{CD_lo}]),
                NASA([1000.0, 5000.0], [{CD_hi}])))
species(name='EF', atoms='H:1 O:2',
        thermo=(NASA([300.0, 1000.0], [{EF_lo}]),
                NASA([1000.0, 5000.0], [{EF_hi}])))
species(name='N2', atoms='N:2',
        thermo=(NASA([300.0, 1000.0], [{N2_lo}]),
                NASA([1000.0, 5000.0], [{N2_hi}])))

reaction('AB + CD <=> EF', [1.5e+13, 0.5, 2000.0])
three_body_reaction('AB + AB + M <=> CD + M', [2.0e+16, -1.0, 0.0],
                    efficiencies='EF:5.0 N2:0.5')
falloff_reaction('AB + EF (+M) <=> CD + CD (+M)',
                 kf=[7.4e+13, -0.37, 0.0], kf0=[2.3e+18, -0.9, -1700.0],
                 efficiencies='N2:0.7',
                 falloff=Troe(A=0.7346, T3=94.0, T1=1756.0, T2=5182.0))
pdep_arrhenius('AB + CD <=> EF + N2',
               [(0.1, 'atm'), 1.0e+12, 0.0, 1000.0],
               [(1.0, 'atm'), 1.0e+13, 0.0, 900.0])
chebyshev_reaction('CD + EF <=> AB + N2', Tmin=500.0, Tmax=3000.0,
                   Pmin=(0.01, 'atm'), Pmax=(100.0, 'atm'),
                   coeffs=[[7.0, 0.1], [0.05, -0.02]])
chemically_activated_reaction('AB + CD (+N2) => EF (+N2)',
                              kLow=[3.0e+13, 0.0, 100.0],
                              kHigh=[6.0e+7, 0.5, 50.0],
                              falloff=SRI(A=0.54, B=201.0, C=1024.0),
                              options='duplicate')
"""

# (reader, JAX reader, text key, reactions the format holds)
FORMATS = {
    '.cti': ('read_mech_cti', 6),
    '.yaml': ('read_mech_yaml', 5),
    '.xml': ('read_mech_ctml', 6),
}
MODULES = {'read_mech_cti': (cti, jcti), 'read_mech_yaml': (ctyaml, jctyaml),
           'read_mech_ctml': (ctml, jctml)}


def _coeffs(row):
    return ', '.join('%.17g' % float(c) for c in row)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """The mechanism's file in each format, by extension."""
    d = tmp_path_factory.mktemp('formats')
    (d / 'm.inp').write_text(CHEMKIN)
    (d / 'm.yaml').write_text(YAML)
    (d / 'm.yml').write_text(YAML)
    _, specs, _ = ctyaml.read_mech_yaml(str(d / 'm.yaml'))
    th = {s.name: _TH.format(lo=_coeffs(s.lo), hi=_coeffs(s.hi))
          for s in specs}
    (d / 'm.xml').write_text(CTML.format(**th))
    co = {}
    for s in specs:
        co[s.name + '_lo'] = _coeffs(s.lo)
        co[s.name + '_hi'] = _coeffs(s.hi)
    (d / 'm.cti').write_text(CTI.format(**co))
    return {ext: str(d / ('m' + ext)) for ext in
            ('.inp', '.yaml', '.yml', '.xml', '.cti')}


def _same_ir(a, b):
    """Two parser outputs (elems, specs, reacs) equal field for field."""
    assert type(a) is tuple and len(a) == len(b) == 3
    assert a[0] == b[0]
    for xs, ys in zip(a[1:], b[1:]):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            fx, fy = vars(x), vars(y)
            assert fx.keys() == fy.keys()
            for k in fx:
                u, v = fx[k], fy[k]
                if isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
                    assert np.array_equal(u, v), k
                else:
                    assert u == v, (k, u, v)


def _packed_fields(p):
    return {k: getattr(p, k) for k in p.__dataclass_fields__ if k != 'mech'}


def _same_packed(a, b):
    fa, fb = _packed_fields(a), _packed_fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype, k
            assert np.array_equal(fa[k], fb[k]), k
        else:
            assert type(fa[k]) is type(fb[k]) and fa[k] == fb[k], k


@pytest.mark.parametrize('ext', sorted(FORMATS))
def test_format_matches_jax(files, ext):
    """The port's reader gives the JAX package's IR, and its
    ``Mechanism.from_files`` + ``pack`` the JAX package's packed arrays,
    field for field."""
    reader, n_rxn = FORMATS[ext]
    mod, jmod = MODULES[reader]
    got = getattr(mod, reader)(files[ext])
    assert len(got[2]) == n_rxn
    _same_ir(got, getattr(jmod, reader)(files[ext]))
    m = Mechanism.from_files(files[ext])
    jm = JMechanism.from_files(files[ext])
    assert m.species_names == jm.species_names and m.specs[-1].name == 'N2'
    assert m.fwd_spec_mapping == jm.fwd_spec_mapping
    _same_packed(pack(m), jpack(jm))


@pytest.mark.parametrize('ext', sorted(FORMATS))
def test_format_matches_chemkin(files, ext):
    """Each Cantera format packs the three reactions it shares with the
    Chemkin text into the Chemkin route's arrays, bit for bit."""
    ck = Mechanism.from_files(files['.inp'])
    m = Mechanism.from_files(files[ext]).restrict_reactions([0, 1, 2])
    assert m.species_names == ck.species_names
    _same_packed(pack(m), pack(ck))


def test_cti_twin_matches_ctml(files):
    """The CTI twin and the CTML document are one mechanism: equal IR and
    packed arrays, once the Chebyshev reaction's Arrhenius placeholder
    (0 from CTI's reader, 1 from CTML's; it marks the reaction's A_sign)
    is set alike."""
    a = Mechanism.from_files(files['.cti'])
    b = Mechanism.from_files(files['.xml'])
    assert a.reacs[4].cheb and (a.reacs[4].A, b.reacs[4].A) == (0.0, 1.0)
    a.reacs[4].A = 1.0
    _same_ir((a.elems, a.specs, a.reacs), (b.elems, b.specs, b.reacs))
    r = a.reacs[5]
    assert r.pdep and not r.rev and r.dup and r.sri
    _same_packed(pack(a), pack(b))


@pytest.mark.parametrize('ext', ['.inp', '.cti', '.yaml', '.yml', '.xml'])
def test_from_files_dispatches_on_extension(files, ext):
    m = Mechanism.from_files(files[ext])
    assert m.source == os.path.basename(files[ext])
    assert m.n_species == 4 and m.n_reactions == {
        '.inp': 3, '.cti': 6, '.yaml': 5, '.yml': 5, '.xml': 6}[ext]


def test_yaml_reader_imports_pyyaml_lazily():
    """PyYAML is needed only to read a ``.yaml`` file: importing the
    package and its YAML reader loads it not."""
    code = ('import sys, pyjac_tpu_torch, pyjac_tpu_torch.core.ctyaml; '
            'assert "yaml" not in sys.modules; print("ok")')
    out = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr


def test_bad_ctml_raises(tmp_path):
    p = tmp_path / 'bad.xml'
    p.write_text('<notctml/>')
    with pytest.raises(chemkin.MechanismError):
        Mechanism.from_files(str(p))


# ---------------------------------------------------------------------------
# structural sparsity and the CSR export
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def mechs(tmp_path_factory):
    """(port packed, JAX packed, states y, P) of the flagship and the
    9/24 all-features synth."""
    out = {}
    m, p = synthetic.flagship()
    d = np.load(REPO / 'tests' / 'data' / 'flagship_states.npz')
    idx = np.linspace(0, len(d['y']) - 1, 16).astype(int)
    text = synthetic.plausible_mechanism(53, 325, seed=42)
    path = tmp_path_factory.mktemp('flag') / 'flagship.inp'
    path.write_text(text)
    out['flagship'] = (p, jpack(JMechanism.from_files(str(path))),
                       d['y'][idx], d['P'][idx])
    text = jsynth.synthetic_mechanism(n_species=9, n_reactions=24, seed=7)
    path = tmp_path_factory.mktemp('synth') / 'synth.inp'
    path.write_text(text)
    m = Mechanism.from_files(str(path))
    y, _, P = synthetic.random_states(m, 16, seed=2)
    out['synth'] = (pack(m), jpack(JMechanism.from_files(str(path))), y, P)
    return out


@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_sparsity_matches_jax_and_covers_jacobian(mechs, name, conp):
    p, jp, y, P = mechs[name]
    mask = sparse.structural_sparsity(p, conp)
    assert np.array_equal(mask, jsparse.structural_sparsity(jp, conp))
    indptr, indices = sparse.csr_structure(p, conp)
    jptr, jind = jsparse.csr_structure(jp, conp)
    assert indptr.dtype == jptr.dtype and indices.dtype == jind.dtype
    assert np.array_equal(indptr, jptr) and np.array_equal(indices, jind)
    assert sparse.sparsity_summary(p) == jsparse.sparsity_summary(jp)
    # the mask covers every nonzero of the port's Jacobian
    yt = torch.as_tensor(y)
    param = torch.as_tensor(P)
    if not conp:
        from pyjac_tpu_torch.ops.thermo import eval_conc
        param = eval_conc(p, yt[:, 0], param, yt[:, 1:])[2]
    J = eval_jacobian(p, 0.0, param, yt, conp=conp)
    assert torch.isfinite(J).all()
    assert not (J.numpy()[:, ~mask] != 0).any()
    # sparse_values round-trips through CSR, and equals JAX's gather
    vals = sparse.sparse_values(J, indptr, indices)
    assert vals.shape == (len(y), len(indices)) and vals.device == J.device
    for i in range(len(y)):
        dense = scipy.sparse.csr_matrix(
            (vals[i].numpy(), indices, indptr), shape=mask.shape).toarray()
        assert np.array_equal(dense, J[i].numpy())
    assert np.array_equal(vals.numpy(), np.asarray(
        jsparse.sparse_values(J.numpy(), indptr, indices)))


# ---------------------------------------------------------------------------
# state utilities and the native state I/O
# ---------------------------------------------------------------------------

def test_utils_match_jax(mechs):
    p, jp, y, P = mechs['flagship']
    rng = np.random.default_rng(5)
    X = rng.dirichlet(np.ones(p.n_species), size=7)
    for fn in ('mole_to_mass', 'mass_to_mole'):
        assert np.array_equal(getattr(utils, fn)(p, X),
                              getattr(jutils, fn)(jp, X)), fn
    Yf = utils.full_mass_fractions(y)
    assert np.array_equal(Yf, jutils.full_mass_fractions(y))
    assert np.array_equal(utils.get_density(p, y[:, 0], P, Yf),
                          jutils.get_density(jp, y[:, 0], P, Yf))
    assert np.array_equal(utils.state_vector(p, y[:, 0], Yf),
                          jutils.state_vector(jp, y[:, 0], Yf))
    assert np.array_equal(utils.state_vector(p, y[:, 0], Yf), y)
    orig = utils.permute_to_original(p, Yf)
    assert np.array_equal(orig, jutils.permute_to_original(jp, Yf))
    assert np.array_equal(utils.permute_to_internal(p, orig),
                          jutils.permute_to_internal(jp, orig))
    names = p.species_names
    spec = '1200, 10, %s=0.79, %s=0.2, %s=0.01' % (names[-1], names[0],
                                                   names[3])
    for a, b in zip(utils.parse_initial_conditions(p, spec),
                    jutils.parse_initial_conditions(jp, spec)):
        assert np.array_equal(a, b)
    for bad in ('1200,1', '1200,1,NOPE=1', '1200,1,%s' % names[0],
                '1200,1,%s=0' % names[0]):
        with pytest.raises(ValueError):
            utils.parse_initial_conditions(p, bad)
    assert not hasattr(utils, 'check_dd_range')


@pytest.fixture
def fresh_stateio(tmp_path, monkeypatch):
    """The port's stateio with its library built into ``tmp_path`` (the
    port's build directory, by the environment variable)."""
    monkeypatch.setenv('PYJAC_TORCH_BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(stateio, '_lib', None)
    monkeypatch.setattr(stateio, '_lib_tried', False)
    return tmp_path


def test_stateio_builds_under_build_dir(fresh_stateio):
    before = sorted(os.listdir(REPO / 'pyjac_tpu_torch' / 'runtime'))
    assert stateio.native_available()
    built = [f for f in os.listdir(fresh_stateio) if f.endswith('.so')]
    assert len(built) == 1 and built[0].startswith('libstateio_')
    # nothing built next to the source, nothing left half-written
    assert sorted(os.listdir(REPO / 'pyjac_tpu_torch' / 'runtime')) == before
    assert os.listdir(fresh_stateio) == built


@pytest.mark.parametrize('native', [True, False], ids=['native', 'numpy'])
def test_stateio_matches_jax(fresh_stateio, monkeypatch, mechs, tmp_path,
                             native):
    """Save/load round trip, and the state build, SoA transpose and
    density equal the JAX package's on the flagship's rows, through the
    port's native library and through its NumPy fallback.  The JAX side
    runs its NumPy fallback: its native build writes next to its source,
    which the JAX package's own tests do."""
    monkeypatch.setattr(jstateio, '_lib', None)
    monkeypatch.setattr(jstateio, '_lib_tried', True)
    if not native:
        monkeypatch.setattr(stateio, '_lib_tried', True)
    assert stateio.native_available() is native
    p, jp, y, P = mechs['flagship']
    Yf = utils.full_mass_fractions(y)
    rows = np.concatenate([np.arange(len(y))[:, None] * 1e-6, y[:, :1],
                           P[:, None], utils.permute_to_original(p, Yf)], 1)
    path = str(tmp_path / 'data.bin')
    stateio.save_raw(path, rows)
    back = stateio.load_raw(path, rows.shape[1])
    assert np.array_equal(back, rows)
    assert np.array_equal(stateio.load_raw(path, rows.shape[1], max_rows=5),
                          rows[:5])
    assert np.array_equal(np.fromfile(path, '<f8').reshape(rows.shape), rows)
    got = stateio.build_states(rows, p.mech.fwd_spec_mapping)
    want = jstateio.build_states(rows, jp.mech.fwd_spec_mapping)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert np.array_equal(got[0], y) and np.array_equal(got[1], P)
    assert np.array_equal(stateio.to_soa(rows), jstateio.to_soa(rows))
    rho = stateio.density(y[:, 0], P, Yf, np.asarray(p.mw))
    np.testing.assert_allclose(
        rho, jstateio.density(y[:, 0], P, Yf, np.asarray(jp.mw)),
        rtol=1e-15, atol=0)


# ---------------------------------------------------------------------------
# the command-line interface
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def synth_inp(tmp_path_factory):
    path = tmp_path_factory.mktemp('cli') / 'synth.inp'
    path.write_text(synthetic.synthetic_mechanism(n_species=9,
                                                  n_reactions=24, seed=7))
    return str(path)


def test_cli_matches_jax(synth_inp, tmp_path):
    """Both CLIs write the same manifest, the same initial state and
    archives each package loads into the other's packed arrays."""
    names = Mechanism.from_files(synth_inp).species_names
    ic = '1000,2,%s=0.5,%s=0.3,%s=0.2' % (names[-1], names[0], names[2])
    out, jout = tmp_path / 'port', tmp_path / 'jax'
    assert cli.main(['-i', synth_inp, '-b', str(out), '-ic', ic]) == 0
    assert jcli.main(['-i', synth_inp, '-b', str(jout), '-ic', ic]) == 0
    man = json.loads((out / 'mechanism_info.json').read_text())
    assert man == json.loads((jout / 'mechanism_info.json').read_text())
    assert np.array_equal(np.load(out / 'initial_state.npy'),
                          np.load(jout / 'initial_state.npy'))
    p = pack(Mechanism.from_files(synth_inp))
    jp = jpack(JMechanism.from_files(synth_inp))
    _same_packed(load_packed(str(jout / 'mech_packed.npz')), p)
    _same_packed(jload_packed(str(out / 'mech_packed.npz')), jp)


@pytest.mark.parametrize('conv', [False, True], ids=['conp', 'conv'])
def test_cli_validate(synth_inp, tmp_path, capsys, conv):
    args = ['-i', synth_inp, '-b', str(tmp_path), '--validate',
            '--device', 'cpu'] + (['--conv'] if conv else [])
    assert cli.main(args) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if 'self-validation' in ln]
    assert len(line) == 1 and ('CONV' if conv else 'CONP') in line[0]
    assert float(line[0].split()[-1]) <= 1e-8
    # --skip_jac skips it
    assert cli.main(args + ['--skip_jac']) == 0
    assert 'self-validation' not in capsys.readouterr().out


def test_cli_validate_needs_a_card_unless_asked(synth_inp, tmp_path):
    """``--validate`` runs on the card unless ``--device cpu`` asks for the
    CPU; without a card it raises, as the other entry points do."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['-i', synth_inp, '-b', str(tmp_path), '--validate'])


def test_cli_module_runs(synth_inp, tmp_path):
    """``python -m pyjac_tpu_torch`` packs a mechanism."""
    out = subprocess.run(
        [sys.executable, '-m', 'pyjac_tpu_torch', '-i', synth_inp, '-b',
         str(tmp_path)], cwd=str(REPO), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / 'mech_packed.npz').exists()
    assert dataclasses.is_dataclass(load_packed(str(tmp_path /
                                                    'mech_packed.npz')))
