"""Mechanism container: species pivoting, index resolution, mappings.

Implements the last-species elimination bookkeeping of the reference
(reference: pyjac/utils.py:55-91 ``get_species_mappings``,
pyjac/utils.py:250-277 ``reassign_species_lists``, and the default
last-species selection of pyjac/core/create_jacobian.py:3503-3542).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from . import chemkin
from .constants import get_elem_wt
from .ir import Reaction, Species

log = logging.getLogger(__name__)


def get_species_mappings(num_specs: int, last_species: int):
    """Forward/backward index maps that move ``last_species`` to the end.

    fwd[new_index] = old_index, back[old_index] = new_index
    (reference parity: pyjac/utils.py:55-91).
    """
    fwd = [i for i in range(num_specs) if i != last_species] + [last_species]
    back = [0] * num_specs
    for new, old in enumerate(fwd):
        back[old] = new
    return fwd, back


def find_last_species(specs: Sequence[Species],
                      last_spec: Optional[str] = None) -> int:
    """Pick the species eliminated by the 1 - sum(Y) closure.

    User choice wins; otherwise the first of N2 / Ar / He present with a
    matching molecular weight; otherwise the mechanism's final species
    (reference: pyjac/core/create_jacobian.py:3503-3542).
    """
    if last_spec is not None:
        idx = next((i for i, sp in enumerate(specs)
                    if sp.name.lower() == last_spec.lower().strip()), None)
        if idx is not None:
            return idx
        log.warning('user-specified last species %s not found; '
                    'falling back to defaults', last_spec)
    wt = get_elem_wt()
    candidates = [('N2', wt['n'] * 2.), ('Ar', wt['ar']), ('He', wt['he'])]
    for name, mw in candidates:
        idx = next((i for i, sp in enumerate(specs)
                    if sp.name.lower() == name.lower() and sp.mw == mw), None)
        if idx is not None:
            return idx
    log.warning('no default last species found; using final species %s',
                specs[-1].name)
    return len(specs) - 1


def resolve_species(reacs: Sequence[Reaction],
                    specs: Sequence[Species]) -> None:
    """Rewrite species names in reactions to integer indices in place
    (reference parity: pyjac/utils.py:250-277)."""
    index = {sp.name: i for i, sp in enumerate(specs)}
    for rxn in reacs:
        rxn.reac = [index[s] if isinstance(s, str) else s for s in rxn.reac]
        rxn.prod = [index[s] if isinstance(s, str) else s for s in rxn.prod]
        rxn.thd_body_eff = [[index[s] if isinstance(s, str) else s, eff]
                            for s, eff in rxn.thd_body_eff]
        if rxn.pdep_sp not in ('', None) and isinstance(rxn.pdep_sp, str):
            rxn.pdep_sp = index[rxn.pdep_sp]
        elif rxn.pdep_sp == '':
            rxn.pdep_sp = None


@dataclass
class Mechanism:
    """A parsed mechanism, pivoted so the eliminated species is last.

    ``fwd_spec_mapping[new] = original`` and
    ``back_spec_mapping[original] = new`` reproduce the permutation
    metadata the reference embeds in generated headers and re-parses in
    its functional tester (reference: pyjac/functional_tester/test.py:334-430).
    """

    elems: List[str]
    specs: List[Species]
    reacs: List[Reaction]
    last_spec: int
    fwd_spec_mapping: List[int]
    back_spec_mapping: List[int]
    source: str = ''

    @property
    def n_species(self) -> int:
        return len(self.specs)

    @property
    def n_reactions(self) -> int:
        return len(self.reacs)

    @property
    def species_names(self) -> List[str]:
        return [sp.name for sp in self.specs]

    @classmethod
    def from_files(cls, mech_path: str, therm_path: Optional[str] = None,
                   last_spec: Optional[str] = None) -> "Mechanism":
        """Load a Chemkin ``.inp/.dat`` mechanism.

        The Cantera ``.cti`` / YAML / CTML parsers are not ported yet
        (ROADMAP.md, queue 1: "parsers cti/ctyaml/ctml")."""
        if mech_path.endswith(('.cti', '.yaml', '.yml', '.xml')):
            raise NotImplementedError(
                'Cantera mechanism formats (.cti/.yaml/.xml) are not '
                'ported to pyjac_tpu_torch yet (ROADMAP.md queue 1: '
                'parsers cti/ctyaml/ctml); use a Chemkin .inp file')
        elems, specs, reacs = chemkin.read_mech(mech_path, therm_path)
        return cls.from_ir(elems, specs, reacs, last_spec=last_spec,
                           source=os.path.basename(mech_path))

    @classmethod
    def from_ir(cls, elems: List[str], specs: List[Species],
                reacs: List[Reaction], last_spec: Optional[str] = None,
                source: str = '') -> "Mechanism":
        if not specs:
            raise chemkin.MechanismError('no species found')
        if not reacs:
            raise chemkin.MechanismError('no reactions found')
        last = find_last_species(specs, last_spec)
        fwd, back = get_species_mappings(len(specs), last)
        specs = [specs[i] for i in fwd]
        # reactions still name species by string; resolve against the
        # pivoted ordering
        resolve_species(reacs, specs)
        return cls(elems=elems, specs=specs, reacs=reacs,
                   last_spec=len(specs) - 1,
                   fwd_spec_mapping=fwd, back_spec_mapping=back,
                   source=source)

    def restrict_reactions(self, indices) -> "Mechanism":
        """A copy of this mechanism stripped to the listed reactions
        (file order) — the functional tester's ``--only_reaction``
        triage hook (reference: pyjac/functional_tester/test.py:1139-1144,
        which rebuilds the Cantera Solution from a reaction subset).
        Species and the last-species pivot are unchanged."""
        import dataclasses
        indices = [int(i) for i in indices]
        n = len(self.reacs)
        bad = [i for i in indices if not (0 <= i < n)]
        if bad:
            raise IndexError('reaction indices out of range: %s (have %d '
                             'reactions)' % (bad, n))
        return dataclasses.replace(
            self, reacs=[self.reacs[i] for i in indices])
