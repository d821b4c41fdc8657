"""The port's SQL parser against ``spark_tpu.sql.parser``: for every TPC-DS
text the port runs, and for the statement and error cases of
``tests/test_sql_parser.py``, both parsers must build structurally equal
plans — node classes, node reprs, expression reprs, sort directions and
nulls order, recursing into subquery plans.  Each construct a later slice
brings raises ``AnalysisException`` naming itself and that slice.
"""

import pytest

from spark_tpu.sql import parser as RP
from spark_tpu.tpcds.queries import QUERIES
from spark_tpu_torch.expressions import AnalysisException
from spark_tpu_torch.sql import parser as TP

#: the TPC-DS queries the port runs from SQL text
PORTED_QUERIES = (
    # the parser alone
    "q3 q7 q13 q21 q25 q26 q28 q29 q31 q34 q37 q40 q42 q43 q46 q48 q50 q52 "
    "q55 q59 q61 q64 q65 q68 q72 q73 q82 q84 q88 q90 q93 q96 q97 "
    # subqueries, set operations, LIKE
    "q1 q4 q6 q9 q10 q11 q14 q16 q23 q30 q32 q33 q35 q38 q41 q45 q54 q56 "
    "q58 q60 q66 q69 q71 q74 q75 q76 q81 q83 q87 q91 q92 q94 q95").split()

_WINDOWS = "the window-function slice"
_GSETS = "the TPC-DS breadth slice (ROLLUP/CUBE/grouping sets)"
_STRINGS = "the TPC-DS breadth slice (string functions)"
_MATH = "the TPC-DS breadth slice (math functions)"
_STATS = "the TPC-DS breadth slice (statistical aggregates)"

#: the other TPC-DS queries: the first construct each reaches that a later
#: slice brings, and that slice
EXCLUDED_QUERIES = {
    **{q: ("OVER", _WINDOWS) for q in
       "q12 q20 q47 q51 q53 q57 q63 q89 q98".split()},
    **{q: ("rank", _WINDOWS) for q in "q44 q49 q67".split()},
    **{q: ("ROLLUP", _GSETS) for q in "q5 q18 q22 q77 q80".split()},
    **{q: ("grouping", _GSETS) for q in "q27 q36 q70 q86".split()},
    **{q: ("substr", _STRINGS) for q in
       "q8 q15 q19 q62 q79 q85 q99".split()},
    **{q: ("round", _MATH) for q in "q2 q78".split()},
    **{q: ("stddev_samp", _STATS) for q in "q17 q39".split()},
    "q24": ("upper", _STRINGS),
}


def test_query_lists_cover_tpcds():
    assert len(PORTED_QUERIES) == 66 and len(EXCLUDED_QUERIES) == 33
    assert sorted(PORTED_QUERIES + list(EXCLUDED_QUERIES)) == sorted(QUERIES)


def _subquery_plans(e):
    out = []
    if hasattr(e, "plan"):
        out.append(e.plan)
    for c in e.children:
        out += _subquery_plans(c)
    return out


def signature(plan):
    """A package-neutral description of a parsed plan."""
    if not hasattr(plan, "children") or not hasattr(plan, "schema"):
        return ("command", type(plan).__name__,
                {k: signature(v) if hasattr(v, "schema") else repr(v)
                 for k, v in sorted(vars(plan).items())})
    exprs = list(plan.expressions())
    extra = []
    if type(plan).__name__ == "Aggregate":
        extra = [n for _f, n in plan.aggs]
    if type(plan).__name__ == "Sort":
        extra = [(o.ascending, o.nulls_first) for o in plan.orders] \
            + [plan.is_global]
    if type(plan).__name__ == "Join":
        extra = [plan.how, plan.using]
    if type(plan).__name__ == "SubqueryAlias":
        extra = [plan.alias]
    subs = [signature(p) for e in exprs for p in _subquery_plans(e)]
    return (type(plan).__name__, repr(plan), [repr(e) for e in exprs],
            [type(e).__name__ for e in exprs], extra, subs,
            [signature(c) for c in plan.children])


@pytest.mark.parametrize("qname", PORTED_QUERIES)
def test_tpcds_text_parses_like_reference(qname):
    sql = QUERIES[qname]
    assert signature(TP.parse_query(sql)) == signature(RP.parse_query(sql))


@pytest.mark.parametrize("qname", sorted(EXCLUDED_QUERIES))
def test_excluded_tpcds_text_names_construct_and_slice(qname):
    construct, where = EXCLUDED_QUERIES[qname]
    with pytest.raises(AnalysisException) as ei:
        TP.parse_query(QUERIES[qname])
    assert str(ei.value) == \
        f"{construct} is not ported yet: it comes with {where}"


@pytest.mark.parametrize("text", [
    "1 + 2 * 3",
    "a > 1 AND b <= 2 OR NOT c = 3",
    "x IS NOT NULL AND y IS NULL",
    "k NOT IN (1, 2, 3)",
    "v NOT BETWEEN 1 AND 10",
    "name LIKE 'a%'",
    "name NOT LIKE 'a\\\\_b%'",
    "name RLIKE '^[ab]+$'",
    "CASE k WHEN 1 THEN 'one' WHEN 2 THEN 'two' ELSE 'many' END",
    "CASE WHEN v >= 40 THEN 'big' ELSE 'small' END AS size",
    "CAST(v AS double) / 4",
    "CAST(v AS decimal(7,2))",
    "NULL <=> NULL",
    "coalesce(a, b, 0) + nvl(c, 1) - ifnull(d, 2)",
    "nullif(a, 0) * nvl2(a, 1, 2) % pmod(a, 3)",
    "if(a > 1, 'x', 'y')",
    "count(DISTINCT name)",
    "sum(DISTINCT v) + count(*) + count(1) + count(NULL)",
    "approx_count_distinct(x, 0.05)",
    "first(x) + last_value(y) + mean(z)",
    "nosuchfunction(x)",
    "hash(a, b)",
    "-x + +y",
    "1.5e3 + 2d + 7L + .5",
    "`odd name` + t.k",
    "'it''s' ",
])
def test_expression_parses_like_reference(text):
    r, t = RP.parse_expression(text), TP.parse_expression(text)
    assert repr(t) == repr(r)
    assert type(t).__name__ == type(r).__name__


@pytest.mark.parametrize("text", [
    "SELECT * FROM t",
    "SELECT DISTINCT k FROM t",
    "SELECT 1 + 1 AS two, 'x' AS s",
    "SELECT v FROM t WHERE k = 1 ORDER BY v DESC NULLS FIRST LIMIT 2",
    "SELECT k, sum(v) AS s, count(*) AS c FROM t GROUP BY k "
    "HAVING count(*) > 1 ORDER BY k",
    "SELECT k, sum(v) FROM t GROUP BY 1 ORDER BY 2",
    "SELECT k, sum(v) / count(v) AS avg_v FROM t GROUP BY k SORT BY k",
    "SELECT t.v, d.label FROM t JOIN d ON t.k = d.k WHERE t.v >= 30",
    "SELECT k, v, label FROM t JOIN d USING (k)",
    "SELECT t.k FROM t LEFT OUTER JOIN d ON t.k = d.k",
    "SELECT * FROM t LEFT SEMI JOIN d ON t.k = d.k",
    "SELECT * FROM t LEFT ANTI JOIN d ON t.k = d.k",
    "SELECT * FROM t RIGHT JOIN d ON t.k = d.k FULL OUTER JOIN e ON 1 = 1",
    "SELECT * FROM t CROSS JOIN d, e",
    "SELECT s.k FROM (SELECT k, sum(v) AS s FROM t GROUP BY k) s",
    "WITH agg AS (SELECT k FROM t), b AS (SELECT k FROM agg) "
    "SELECT k FROM b WHERE k IN (SELECT k FROM agg)",
    "SELECT k FROM t UNION ALL SELECT k FROM d ORDER BY k LIMIT 3",
    "SELECT k FROM t UNION SELECT k FROM d",
    "SELECT k FROM t UNION DISTINCT SELECT k FROM d",
    "SELECT k FROM t WHERE k = 1 UNION "
    "SELECT k FROM t INTERSECT SELECT k2 FROM u",
    "SELECT k FROM t EXCEPT SELECT k2 FROM u MINUS SELECT 1",
    "(SELECT k FROM t) INTERSECT DISTINCT (SELECT k FROM u)",
    "SELECT t.* FROM t JOIN d ON t.k = d.k",
    "SELECT id * 2 AS x FROM range(2, 5) r",
    "SELECT id FROM range(10)",
    "SELECT k FROM t WHERE EXISTS (SELECT * FROM u WHERE u.k2 = t.k)",
    "SELECT k FROM t WHERE NOT EXISTS (SELECT 1 FROM u WHERE u.k2 = t.k "
    "LIMIT 1)",
    "SELECT k FROM t WHERE v > (SELECT AVG(t2.v) FROM t t2 "
    "WHERE t2.g = t.g)",
    "SELECT a, (SELECT SUM(b) FROM t2) AS s FROM t1",
    "SELECT k FROM db.t AS x",
    "SELECT first, last FROM t",
])
def test_query_parses_like_reference(text):
    assert signature(TP.parse_query(text)) == signature(RP.parse_query(text))


@pytest.mark.parametrize("text", [
    "CREATE TEMP VIEW v AS SELECT 1 AS x",
    "CREATE OR REPLACE TEMPORARY VIEW v AS SELECT x * 2 AS y FROM b",
    "DROP VIEW v", "DROP VIEW IF EXISTS v",
    "SHOW TABLES", "SHOW DATABASES",
    "DESCRIBE t", "DESCRIBE TABLE EXTENDED t", "DESCRIBE EXTENDED t",
    "SET", "SET spark.tpu.test.flag=17", "SET spark.sql.x",
    "SET spark.tpu.test.path=/a:b;c{d}$e",
    "EXPLAIN SELECT k FROM t", "EXPLAIN EXTENDED SELECT k FROM t",
    "CREATE TABLE IF NOT EXISTS db.t (a int, b decimal(7,2)) USING parquet",
    "CREATE OR REPLACE TABLE t USING csv AS SELECT 1 AS a",
    "INSERT INTO t SELECT 1", "INSERT OVERWRITE TABLE t SELECT 2",
    "DROP TABLE IF EXISTS t", "DROP TABLE db.t",
    "CREATE DATABASE IF NOT EXISTS db", "DROP DATABASE IF EXISTS db",
    "USE db",
    "ANALYZE TABLE t COMPUTE STATISTICS",
    "ANALYZE TABLE t COMPUTE STATISTICS FOR ALL COLUMNS",
    "ANALYZE TABLE t COMPUTE STATISTICS FOR COLUMNS a, b",
])
def test_statement_parses_like_reference(text):
    assert signature(TP.parse_statement(text)) \
        == signature(RP.parse_statement(text))


@pytest.mark.parametrize("text,kind", [
    ("1 +", "expression"), ("foo(", "expression"), ("(1", "expression"),
    ("a IN (b)", "expression"), ("name LIKE x", "expression"),
    ("CAST(x AS nosuchtype)", "expression"), ("CASE END", "expression"),
    ("SELECT FROM t", "query"), ("SELECT k FROM t LIMIT x", "query"),
    ("SELECT * FROM t GROUP BY k", "query"),
    ("SELECT k FROM t extra junk", "query"),
    ("CREATE VIEW v AS SELECT 1", "statement"),
    ("CREATE OR REPLACE DATABASE d", "statement"),
    ("CREATE TABLE t", "statement"),
    ("SELECT 1 FROM range(a)", "query"),
    ("SELECT 'a' @ 1", "query"),
])
def test_parse_errors_like_reference(text, kind):
    parse = {"expression": "parse_expression", "query": "parse_query",
             "statement": "parse_statement"}[kind]
    with pytest.raises(RP.ParseException) as r:
        getattr(RP, parse)(text)
    with pytest.raises(TP.ParseException) as t:
        getattr(TP, parse)(text)
    assert str(t.value) == str(r.value)


@pytest.mark.parametrize("text,construct,where", [
    ("a || b", "||", _STRINGS),
    ("exists(arr, x -> x > 1)", "exists", "the TPC-DS breadth slice "
     "(array columns)"),
    ("transform(arr, x -> x + 1)", "transform", "the TPC-DS breadth slice "
     "(array columns)"),
    ("sum(x) OVER (PARTITION BY k)", "OVER", _WINDOWS),
    ("row_number()", "row_number", _WINDOWS),
    ("year(d)", "year", "the TPC-DS breadth slice (date functions)"),
    ("rand(7)", "rand", "the TPC-DS breadth slice (rand/sample)"),
    ("collect_list(x)", "collect_list", _STATS),
    ("window(ts, '5 minutes')", "window",
     "the streaming slice (event-time windows)"),
])
def test_unported_expression_names_construct_and_slice(text, construct,
                                                       where):
    with pytest.raises(AnalysisException) as ei:
        TP.parse_expression(text)
    assert str(ei.value) == \
        f"{construct} is not ported yet: it comes with {where}"


@pytest.mark.parametrize("grouping,construct", [
    ("ROLLUP(a, b)", "ROLLUP"), ("CUBE(a)", "CUBE"),
    ("GROUPING SETS ((a), ())", "GROUPING SETS"),
])
def test_grouping_sets_name_construct_and_slice(grouping, construct):
    with pytest.raises(AnalysisException) as ei:
        TP.parse_query(f"SELECT a, SUM(v) FROM t GROUP BY {grouping}")
    assert str(ei.value) == \
        f"{construct} is not ported yet: it comes with {_GSETS}"


def test_every_reference_function_is_registered_or_named():
    """Each function name the reference parser registers is either
    registered here or raises naming its slice — none falls through to
    the UDF lookup."""
    from spark_tpu_torch.sql.analyzer import NOT_PORTED_FUNCTIONS
    ref = set(RP.SCALAR_FUNCTIONS) | set(RP.AGG_FUNCTIONS) \
        | set(RP._window_registry()) | set(RP.Parser._HOF_NAMES) \
        | {"count", "approx_count_distinct", "percentile_approx",
           "approx_percentile"}
    ported = set(TP.SCALAR_FUNCTIONS) | set(TP.AGG_FUNCTIONS) \
        | {"count", "approx_count_distinct"}
    assert not ported & set(NOT_PORTED_FUNCTIONS)
    assert ref <= ported | set(NOT_PORTED_FUNCTIONS), \
        sorted(ref - ported - set(NOT_PORTED_FUNCTIONS))
