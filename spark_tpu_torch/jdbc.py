"""DB-API-backed relational datasource — the JDBC source analog (the port
of ``spark_tpu/jdbc.py``).

Reference roles covered:
- ``sql/core/src/main/scala/.../datasources/jdbc/JDBCRDD.scala``
  (``scanTable``: pruned column list + pushed WHERE + one partition
  predicate per task);
- ``JDBCRelation.scala`` ``columnPartition`` (stride partitioning of
  ``[lowerBound, upperBound)`` on a numeric partition column, first/last
  partitions open-ended, NULLs in the first);
- ``JdbcUtils.scala`` ``savePartition`` / ``createTable`` (write path:
  schema-derived DDL + batched parameterized INSERTs).

There is no JVM and no JDBC driver manager here.  The wire role is
played by DB-API 2.0 (PEP 249) connections — ``sqlite3`` from the
standard library always works; any other installed driver module is
loaded by URL scheme (``postgresql://...`` → ``import postgresql``) or
named explicitly via the ``driver`` option.  All partition queries of a
relation land in one pyarrow table, which enters the SAME columnar scan
path as every file format (``io._load_batch``: one host batch, pinned
on a ``cuda`` session, copied to the card by the stage that reads it),
so pruning, the multi-batch runner and the stage runner see no
difference between a parquet directory and a database table.  The
database is read on the host; nothing here runs on the card.

Freshness: unlike file relations (cached by their files' stat),
database DATA reads are NEVER cached — a mutable store has no cheap
invalidation token, so every query re-reads.  The resolved schema and
COUNT(*) planning stats ARE memoized per relation (and evicted by our
own writes): they play the role of the reference's ANALYZE-gathered
statistics, which are exactly as stale.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from .expressions import AnalysisException

#: subquery alias for query-shaped relations (JDBCRelation quotes its
#: ``query`` option the same way)
_SUBQ = "spark_tpu_subquery"


# ---------------------------------------------------------------------------
# connections
# ---------------------------------------------------------------------------

def _normalize_url(url: str) -> str:
    return url[5:] if url.lower().startswith("jdbc:") else url


def _sqlite_path(url: str) -> str:
    """``sqlite:///abs/path`` / ``sqlite:/abs/path`` / ``sqlite:rel`` →
    filesystem path for sqlite3.connect.  ``:memory:`` is rejected: each
    connect() would open a DISTINCT empty database (this module opens a
    fresh connection per operation), so in-memory writes would always be
    silently lost."""
    rest = url.split(":", 1)[1]
    if rest in (":memory:", "memory:"):
        raise AnalysisException(
            "jdbc:sqlite::memory: is not supported: every read/write "
            "opens its own connection, and an in-memory sqlite database "
            "dies with its connection — use a file-backed database")
    while rest.startswith("//"):
        rest = rest[1:]
    return rest


def connect(url: str, options: Dict[str, str], create: bool = False):
    """Open a DB-API connection for `url`.  Returns (connection,
    paramstyle).  ``create=True`` (write path) lets sqlite bootstrap a
    missing database file; reads of a missing file stay a loud error
    (sqlite3.connect would silently create an empty db and every query
    would report zero rows)."""
    url = _normalize_url(url)
    scheme = url.split(":", 1)[0].lower() if ":" in url else ""
    driver = options.get("driver")
    if driver is None and scheme in ("sqlite", "sqlite3", ""):
        import sqlite3
        path = _sqlite_path(url) if ":" in url else url
        if not create and not os.path.exists(path):
            raise AnalysisException(f"sqlite database not found: {path}")
        return sqlite3.connect(path), "qmark"
    mod_name = driver or scheme
    try:
        mod = __import__(mod_name)
    except ImportError as e:
        raise AnalysisException(
            f"no DB-API driver for jdbc url {url!r}: module {mod_name!r} "
            "is not installed (set the `driver` option to a PEP 249 "
            "module name)") from e
    conn = mod.connect(url)
    return conn, getattr(mod, "paramstyle", "qmark")


# ---------------------------------------------------------------------------
# partitioning (JDBCRelation.columnPartition)
# ---------------------------------------------------------------------------

def partition_predicates(options: Dict[str, str]) -> List[Optional[str]]:
    """One SQL predicate per read partition.

    Explicit ``predicates`` (unit-separator-joined, set by
    ``DataFrameReader.jdbc``) win; else stride partitioning of
    [lowerbound, upperbound) on ``partitioncolumn`` into
    ``numpartitions`` ranges — first/last open-ended so no row outside
    the bounds is lost, NULLs ride the first partition (exactly
    ``JDBCRelation.scala`` ``columnPartition``'s clauses)."""
    preds = options.get("predicates")
    if preds:
        return list(preds.split("\x1f"))
    col = options.get("partitioncolumn")
    n = int(options.get("numpartitions", "1") or 1)
    if not col or n <= 1:
        return [None]
    lo = int(options["lowerbound"])
    hi = int(options["upperbound"])
    if hi <= lo:
        raise AnalysisException(
            f"jdbc upperBound ({hi}) must exceed lowerBound ({lo})")
    stride = max((hi - lo) // n, 1)
    out: List[Optional[str]] = []
    for i in range(n):
        low = lo + i * stride
        up = lo + (i + 1) * stride
        if i == 0:
            out.append(f'"{col}" < {up} OR "{col}" IS NULL')
        elif i == n - 1:
            out.append(f'"{col}" >= {low}')
        else:
            out.append(f'"{col}" >= {low} AND "{col}" < {up}')
    return out


def _pushed_sql(pushed) -> List[str]:
    """Engine pushdown tuples (name, op, value) → SQL conjuncts.

    Only predicates whose SQL semantics provably match the engine's are
    emitted (int comparisons; string EQUALITY — inequality is collation-
    dependent).  The exact Filter stays in the plan either way
    (optimizer.push_scan_filters), so this is a row-reduction hint that
    can never change results — but it must never DROP a row the engine
    filter keeps, hence the conservatism."""
    out = []
    for name, op, val in pushed or ():
        sql_op = {"==": "=", "<": "<", "<=": "<=",
                  ">": ">", ">=": ">="}.get(op)
        if sql_op is None:
            continue
        if isinstance(val, str):
            if sql_op != "=":
                continue
            lit = "'" + val.replace("'", "''") + "'"
        else:
            lit = str(int(val))
        out.append(f'"{name}" {sql_op} {lit}')
    return out


# ---------------------------------------------------------------------------
# read path (JDBCRDD.scanTable)
# ---------------------------------------------------------------------------

def _table_expr(options: Dict[str, str]) -> str:
    table = options.get("dbtable")
    query = options.get("query")
    if table and query:
        raise AnalysisException("specify either dbtable or query, not both")
    if query:
        return f"({query}) {_SUBQ}"
    if not table:
        raise AnalysisException("jdbc source requires a dbtable or query "
                                "option")
    return table


def _select_sql(options, columns, pushed, part_pred: Optional[str],
                limit: Optional[int] = None) -> str:
    cols = "*"
    if columns is not None:
        cols = ", ".join(f'"{c}"' for c in columns) if columns else "1"
    where = _pushed_sql(pushed)
    if part_pred:
        where.append(f"({part_pred})")
    sql = f"SELECT {cols} FROM {_table_expr(options)}"
    if where:
        sql += " WHERE " + " AND ".join(where)
    if limit is not None:
        sql += f" LIMIT {int(limit)}"
    return sql


def _rows_to_table(names: List[str], rows: List[tuple]):
    """Column-major pyarrow table from fetched DB rows, with type
    inference the DB cannot provide (DB-API description type codes are
    driver-specific): int→int64, float (or int/float mix)→float64,
    str→string, bytes→binary, bool→bool; all-NULL columns are typed
    ``pa.null()`` so partition concatenation promotes them to whatever
    the other partitions carry.  sqlite stores dates as TEXT — they
    arrive as strings, and ``to_date``/casts take it from there
    (documented divergence from the JVM's typed ResultSet getters)."""
    from .io import _pyarrow
    pa = _pyarrow()
    cols = list(zip(*rows)) if rows else [() for _ in names]
    arrays = []
    for vals in cols:
        nn = [v for v in vals if v is not None]
        if not nn:
            t = pa.null()
        elif all(isinstance(v, bool) for v in nn):
            t = pa.bool_()
        elif all(isinstance(v, int) and not isinstance(v, bool)
                 for v in nn):
            t = pa.int64()
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool)
                 for v in nn):
            t = pa.float64()
            vals = tuple(None if v is None else float(v) for v in vals)
        elif all(isinstance(v, bytes) for v in nn):
            t = pa.binary()
        else:
            t = pa.string()
            vals = tuple(None if v is None else str(v) for v in vals)
        arrays.append(pa.array(list(vals), t))
    return pa.table(dict(zip(names, arrays)))


#: arrow schema per (url, dbtable/query): ONE inference per relation so
#: every scan delivers the dtypes the planner resolved against, even when
#: a pushed WHERE or a partition predicate leaves a column all-NULL
_ARROW_SCHEMA_CACHE: Dict[tuple, object] = {}


def _arrow_schema(url: str, options: Dict[str, str], sample_rows: int = 200):
    """Relation arrow schema from a LIMIT-sample probe (cursor
    descriptions carry no portable types; ``JDBCRDD.resolveTable`` uses
    ResultSetMetaData — the DB-API equivalent is value inference).
    Cached: the schema is resolved once per relation and every scan CASTS
    to it, exactly like the reference fixing the schema at resolveTable
    time.  A column NULL throughout the sample degrades to string."""
    from .io import _pyarrow
    pa = _pyarrow()
    key = (_normalize_url(url), options.get("dbtable"),
           options.get("query"))
    if key in _ARROW_SCHEMA_CACHE:
        return _ARROW_SCHEMA_CACHE[key]
    conn, _style = connect(url, options)
    try:
        cur = conn.cursor()
        sql = _select_sql(options, None, None, None, limit=sample_rows)
        try:
            cur.execute(sql)
        except Exception as e:
            raise AnalysisException(
                f"jdbc schema probe failed ({e}); query was: {sql}") from e
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    t = _rows_to_table(names, rows)
    fields = [pa.field(f.name, pa.string() if pa.types.is_null(f.type)
              else f.type) for f in t.schema]
    schema = pa.schema(fields)
    _ARROW_SCHEMA_CACHE[key] = schema
    return schema


def read_table(urls: List[str], options: Dict[str, str], columns=None,
               pushed=None, target=None):
    """All partition queries of one jdbc relation → one pyarrow table
    (the eager analog of JDBCRDD's per-partition compute), cast to the
    relation's resolved schema so batch dtypes never drift from the plan.
    ``target`` (an arrow schema) is the RELATION's resolved schema —
    user-declared via ``.schema(...)`` or sample-inferred at load()."""
    from .io import _pyarrow
    pa = _pyarrow()
    if target is None:
        target = _arrow_schema(urls[0], options)
    conn, _style = connect(urls[0], options)
    try:
        cur = conn.cursor()
        tables = []
        names: Optional[List[str]] = None
        for pred in partition_predicates(options):
            sql = _select_sql(options, columns, pushed, pred)
            try:
                cur.execute(sql)
            except Exception as e:
                raise AnalysisException(
                    f"jdbc scan failed ({e}); query was: {sql}") from e
            if names is None:
                names = [d[0] for d in cur.description]
            fetch = int(options.get("fetchsize", "10000") or 10000)
            rows: List[tuple] = []
            while True:
                chunk = cur.fetchmany(fetch)
                if not chunk:
                    break
                rows.extend(chunk)
            tables.append(_rows_to_table(names, rows))
        out = pa.concat_tables(tables, promote_options="permissive")
    finally:
        conn.close()
    cast = pa.schema([target.field(n) if target.get_field_index(n) >= 0
                      else out.schema.field(n) for n in out.column_names])
    try:
        return out.cast(cast)
    except Exception as e:
        raise AnalysisException(
            f"jdbc scan returned values outside the resolved schema "
            f"({e}); if the schema was sample-inferred and the sample is "
            "unrepresentative, declare it explicitly with "
            ".schema(...) — the declared schema becomes the scan's cast "
            "target") from e


def table_schema(url: str, options: Dict[str, str]):
    """Engine schema of a jdbc relation (see ``_arrow_schema``)."""
    from .io import _pyarrow
    pa = _pyarrow()
    from .io import _table_to_batch
    schema = _arrow_schema(url, options)
    return _table_to_batch(schema.empty_table()).schema


#: COUNT(*) per (url, relation) — a planning STATISTIC, probed repeatedly
#: by multi-join planning; evicted by write_table, otherwise as stale as
#: any planner stat (the reference's ANALYZE-gathered stats likewise)
_COUNT_CACHE: Dict[tuple, int] = {}


def count_rows(url: str, options: Dict[str, str]) -> Optional[int]:
    """Planning row-count stat; None (never an exception) when the DB is
    unreachable so planning degrades to no-stats like the file formats."""
    key = (_normalize_url(url), options.get("dbtable"),
           options.get("query"))
    if key in _COUNT_CACHE:
        return _COUNT_CACHE[key]
    try:
        conn, _style = connect(url, options)
        try:
            cur = conn.cursor()
            cur.execute(f"SELECT COUNT(*) FROM {_table_expr(options)}")
            n = int(cur.fetchone()[0])
        finally:
            conn.close()
    except Exception:
        return None
    _COUNT_CACHE[key] = n
    return n


def _evict_relation(url: str, name: str) -> None:
    """Drop cached schema/count entries for one written table — the one
    invalidation token a mutable store does give us is OUR OWN write."""
    key = (_normalize_url(url), name, None)
    _ARROW_SCHEMA_CACHE.pop(key, None)
    _COUNT_CACHE.pop(key, None)


# ---------------------------------------------------------------------------
# write path (JdbcUtils.createTable / savePartition)
# ---------------------------------------------------------------------------

#: keyed by ``str(pa_type)`` — note pyarrow names floats "double"/"float"
_SQL_TYPES = {
    "int64": "BIGINT", "int32": "INTEGER", "int16": "SMALLINT",
    "int8": "SMALLINT", "double": "DOUBLE PRECISION", "float": "REAL",
    "bool": "BOOLEAN", "string": "TEXT", "large_string": "TEXT",
    "binary": "BLOB", "date32[day]": "DATE", "timestamp[us]": "TIMESTAMP",
}


def _placeholders(style: str, n: int) -> str:
    """VALUES placeholders for every PEP 249 paramstyle.  `named` and
    `pyformat` bind by name — ``write_table`` passes dict rows for those."""
    if style == "format":
        return ", ".join(["%s"] * n)
    if style == "pyformat":
        return ", ".join(f"%(p{i})s" for i in range(n))
    if style == "named":
        return ", ".join(f":p{i}" for i in range(n))
    if style == "numeric":
        return ", ".join(f":{i + 1}" for i in range(n))
    return ", ".join(["?"] * n)


def write_table(table, url: str, name: str, mode: str,
                options: Dict[str, str]) -> None:
    """Arrow table → database table.  DDL from the arrow schema; rows via
    batched parameterized INSERTs in ONE transaction (savePartition's
    commit discipline: all rows or none)."""
    _evict_relation(url, name)
    conn, style = connect(url, {**options, "dbtable": name}, create=True)
    try:
        cur = conn.cursor()
        exists = True
        try:
            cur.execute(f'SELECT 1 FROM "{name}" LIMIT 1')
            cur.fetchall()
        except Exception:
            exists = False
            conn.rollback()
        if exists:
            if mode == "errorifexists":
                raise AnalysisException(f"jdbc table {name} already exists")
            if mode == "ignore":
                return
            if mode == "overwrite":
                cur.execute(f'DROP TABLE "{name}"')
                exists = False
        if not exists:
            cols = ", ".join(
                f'"{f.name}" {_SQL_TYPES.get(str(f.type), "TEXT")}'
                for f in table.schema)
            cur.execute(f'CREATE TABLE "{name}" ({cols})')
        ph = _placeholders(style, table.num_columns)
        # explicit column list: append mode must bind by NAME against a
        # pre-existing table whose column order may differ (the silent
        # positional-scramble JdbcUtils.getInsertStatement also avoids)
        collist = ", ".join(f'"{c}"' for c in table.column_names)
        sql = f'INSERT INTO "{name}" ({collist}) VALUES ({ph})'
        pydict = table.to_pydict()
        rows = list(zip(*[pydict[c] for c in table.column_names])) \
            if table.num_rows else []
        if style in ("named", "pyformat"):
            rows = [{f"p{i}": v for i, v in enumerate(r)} for r in rows]
        batch = int(options.get("batchsize", "1000") or 1000)
        for i in range(0, len(rows), batch):
            cur.executemany(sql, rows[i:i + batch])
        conn.commit()
    finally:
        conn.close()
