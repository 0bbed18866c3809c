// The tables of the dense fused kernels K4 / K3 (csrc/dense_fused.cu),
// which the dy/dt kernel (csrc/dydt.cu) takes too (its phases read p, f
// and rxn_order), and the counts of their C entries' arrays.

#pragma once

#include "kinetics.cuh"

// matches the numpy table order of jacobian_dense.fused_tables (the
// closure's jacobian_sparse.finish_tables, the column CSR's entries, the
// orders of the reactions and of each column's rows with their CSR
// ranges) after the K5 tables (jacobian_big.parts_tables)
template <typename S>
struct DenseTables {
  PartsTables<S> p;
  FinishTables<S> f;
  const S* col_coef;
  const int *col_src, *rxn_order, *col_order;
};
#define N_TABLES (N_PARTS_TABLES + N_FINISH_TABLES + 4)
static_assert(sizeof(DenseTables<double>) == N_TABLES * sizeof(void*),
              "DenseTables must be N_TABLES pointers");
#define N_DIMS 11
#define N_PLAN 4
