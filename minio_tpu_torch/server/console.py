"""Embedded web console — the browser UI MinIO ships via minio/console
(cmd/common-main.go embeds it; enabled with MINIO_BROWSER). Scope here is
a self-contained single-file SPA served at /minio/console/: login with
access keys, bucket + object browsing with prefix navigation,
upload/download/delete, server info and a live metrics snapshot. All
data calls are SigV4-signed IN the browser (Web Crypto HMAC-SHA256)
against the same origin's S3/admin APIs — the page itself is static and
unauthenticated, exactly like MinIO's console assets. The page is the
JAX package's, byte for byte; it is answered through server/web.py.
"""

from __future__ import annotations

CONSOLE_HTML = r"""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>minio_tpu console</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root { --bg:#0f1419; --panel:#1c2430; --text:#e6e6e6; --accent:#c72c48;
        --accent2:#4a9eda; --muted:#8899a6; --ok:#3fb950; --err:#f85149; }
* { box-sizing:border-box; }
body { margin:0; font:14px/1.5 system-ui,sans-serif; background:var(--bg);
       color:var(--text); }
header { display:flex; align-items:center; gap:12px; padding:10px 20px;
         background:var(--panel); border-bottom:2px solid var(--accent); }
header h1 { font-size:16px; margin:0; }
header .who { margin-left:auto; color:var(--muted); font-size:12px; }
main { max-width:1100px; margin:20px auto; padding:0 20px; }
.panel { background:var(--panel); border-radius:8px; padding:16px;
         margin-bottom:16px; }
input, button, select { font:inherit; border-radius:4px; border:1px solid
       #30363d; background:#0d1117; color:var(--text); padding:6px 10px; }
button { cursor:pointer; background:var(--accent); border:none; }
button.alt { background:var(--accent2); }
button.ghost { background:transparent; border:1px solid #30363d; }
table { width:100%; border-collapse:collapse; }
td, th { text-align:left; padding:6px 8px; border-bottom:1px solid #21262d; }
th { color:var(--muted); font-weight:500; font-size:12px; }
a { color:var(--accent2); cursor:pointer; text-decoration:none; }
.crumb { color:var(--muted); }
.err { color:var(--err); } .ok { color:var(--ok); }
pre { background:#0d1117; padding:10px; border-radius:6px; overflow:auto;
      font-size:12px; max-height:400px; }
.row { display:flex; gap:8px; align-items:center; flex-wrap:wrap; }
.tabs { display:flex; gap:4px; margin-bottom:16px; }
.tabs button { background:transparent; border:1px solid #30363d; }
.tabs button.active { background:var(--accent); border-color:var(--accent); }
</style>
</head>
<body>
<header><h1>minio_tpu console</h1><span class="who" id="who"></span>
<button class="ghost" id="logout" style="display:none">log out</button></header>
<main id="app"></main>
<script>
"use strict";
const enc = new TextEncoder();
const S = { ak:"", sk:"", token:"", region:"us-east-1" };

async function sha256hex(s){
  const d = await crypto.subtle.digest("SHA-256", typeof s==="string"?enc.encode(s):s);
  return [...new Uint8Array(d)].map(b=>b.toString(16).padStart(2,"0")).join("");
}
async function hmac(key, msg){
  const k = await crypto.subtle.importKey("raw", key, {name:"HMAC",hash:"SHA-256"}, false, ["sign"]);
  return new Uint8Array(await crypto.subtle.sign("HMAC", k, enc.encode(msg)));
}
function uriEnc(s, slash){
  return encodeURIComponent(s).replace(/[!'()*]/g, c=>"%"+c.charCodeAt(0).toString(16).toUpperCase())
    .replace(slash?/%2F/g:/$^/g, "/");
}
async function signedFetch(method, path, query, body, signal){
  const amzdate = new Date().toISOString().replace(/[-:]/g,"").replace(/\..*/,"")+"Z";
  const scopeDate = amzdate.slice(0,8);
  const host = location.host;
  const payloadHash = "UNSIGNED-PAYLOAD";
  const qp = Object.entries(query||{}).map(([k,v])=>[uriEnc(k), uriEnc(String(v))])
    .sort((a,b)=> a[0]<b[0]?-1:a[0]>b[0]?1:0);
  const canonQ = qp.map(([k,v])=>`${k}=${v}`).join("&");
  const canonPath = uriEnc(path, true);
  const headers = {host, "x-amz-content-sha256": payloadHash, "x-amz-date": amzdate};
  if (S.token) headers["x-amz-security-token"] = S.token;
  const signedHeaders = Object.keys(headers).sort().join(";");
  const canonHeaders = Object.keys(headers).sort().map(h=>`${h}:${headers[h]}\n`).join("");
  const canon = [method, canonPath, canonQ, canonHeaders, signedHeaders, payloadHash].join("\n");
  const scope = `${scopeDate}/${S.region}/s3/aws4_request`;
  const sts = ["AWS4-HMAC-SHA256", amzdate, scope, await sha256hex(canon)].join("\n");
  let key = enc.encode("AWS4"+S.sk);
  for (const part of [scopeDate, S.region, "s3", "aws4_request"]) key = await hmac(key, part);
  const sig = [...await hmac(key, sts)].map(b=>b.toString(16).padStart(2,"0")).join("");
  const auth = `AWS4-HMAC-SHA256 Credential=${S.ak}/${scope}, SignedHeaders=${signedHeaders}, Signature=${sig}`;
  const sendHeaders = {"Authorization": auth, "x-amz-content-sha256": payloadHash, "x-amz-date": amzdate};
  if (S.token) sendHeaders["x-amz-security-token"] = S.token;
  return fetch(canonPath + (canonQ?`?${canonQ}`:""), {
    method, body: body===undefined?null:body, headers: sendHeaders, signal,
  });
}
function xml(t){ return new DOMParser().parseFromString(t, "text/xml"); }
function esc(s){ const d=document.createElement("i"); d.textContent=s;
  // innerHTML escapes & < > but NOT quotes; keys land in data-* attributes
  return d.innerHTML.replace(/"/g,"&quot;").replace(/'/g,"&#39;"); }
function fmtSize(n){ if(n<1024) return n+" B"; const u=["KiB","MiB","GiB","TiB"];
  let i=-1; do { n/=1024; i++; } while(n>=1024 && i<u.length-1);
  return n.toFixed(1)+" "+u[i]; }
const app = document.getElementById("app");

function loginView(msg){
  document.getElementById("who").textContent = "";
  document.getElementById("logout").style.display = "none";
  app.innerHTML = `<div class="panel" style="max-width:380px;margin:60px auto">
    <h2>Sign in</h2>
    ${msg?`<p class="err">${esc(msg)}</p>`:""}
    <p><input id="ak" placeholder="access key" style="width:100%"></p>
    <p><input id="sk" placeholder="secret key" type="password" style="width:100%"></p>
    <p><button id="go" style="width:100%">Sign in</button></p></div>`;
  document.getElementById("go").onclick = async ()=>{
    // login = STS AssumeRole: proves the keys AND swaps them for expiring
    // session credentials, so the long-lived secret never persists (the
    // reference console keeps a session token the same way)
    S.ak = document.getElementById("ak").value.trim();
    S.sk = document.getElementById("sk").value;
    S.token = "";
    const r = await signedFetch("POST", "/", {}, "Action=AssumeRole&Version=2011-06-15&DurationSeconds=43200");
    if (r.status !== 200) { S.ak=S.sk=""; loginView(`sign-in failed (HTTP ${r.status})`); return; }
    const doc = xml(await r.text());
    S.ak = doc.querySelector("AccessKeyId").textContent;
    S.sk = doc.querySelector("SecretAccessKey").textContent;
    S.token = doc.querySelector("SessionToken").textContent;
    sessionStorage.setItem("ccreds", JSON.stringify({ak:S.ak, sk:S.sk, token:S.token}));
    mainView("buckets");
  };
}

function shell(tab, content){
  document.getElementById("who").textContent = S.ak;
  document.getElementById("logout").style.display = "";
  app.innerHTML = `<div class="tabs">
    ${["buckets","iam","watch","diagnostics","info","metrics"].map(t=>
      `<button class="${t===tab?"active":""}" data-tab="${t}">${t}</button>`).join("")}
    </div><div id="content">${content}</div>`;
  app.querySelectorAll(".tabs button").forEach(b=>
    b.onclick = ()=>mainView(b.dataset.tab));
}

async function mainView(tab){
  if (watchAbort){ watchAbort.abort(); watchAbort = null; }
  if (tab==="buckets") return bucketsView();
  if (tab==="iam") return iamView();
  if (tab==="watch") return watchView();
  if (tab==="diagnostics") return diagView();
  if (tab==="info") return infoView();
  if (tab==="metrics") return metricsView();
}

function authFailed(r){
  if (r.status===401 || r.status===403){
    sessionStorage.removeItem("ccreds"); S.ak=S.sk=S.token="";
    loginView(`session rejected (HTTP ${r.status}) — sign in again`);
    return true;
  }
  return false;
}

async function bucketsView(){
  const r = await signedFetch("GET", "/", {});
  if (authFailed(r)) return;
  if (r.status !== 200){
    shell("buckets", `<div class="panel err">ListBuckets failed: HTTP ${r.status}</div>`);
    return;
  }
  const doc = xml(await r.text());
  const names = [...doc.querySelectorAll("Bucket > Name")].map(n=>n.textContent);
  shell("buckets", `<div class="panel"><div class="row">
      <input id="newb" placeholder="new bucket name">
      <button id="mk">create bucket</button></div></div>
    <div class="panel"><table><tr><th>bucket</th><th></th></tr>
    ${names.map(n=>`<tr><td><a data-b="${esc(n)}">${esc(n)}</a></td>
      <td style="text-align:right"><button class="ghost" data-del="${esc(n)}">delete</button></td></tr>`).join("")}
    </table></div>`);
  document.getElementById("mk").onclick = async ()=>{
    const n = document.getElementById("newb").value.trim();
    if (!n) return;
    const r = await signedFetch("PUT", "/"+n, {});
    if (r.status!==200) alert("create failed: "+await r.text()); else bucketsView();
  };
  app.querySelectorAll("a[data-b]").forEach(a=> a.onclick = ()=>objectsView(a.dataset.b, ""));
  app.querySelectorAll("button[data-del]").forEach(b=> b.onclick = async ()=>{
    if (!confirm(`delete bucket ${b.dataset.del}?`)) return;
    const r = await signedFetch("DELETE", "/"+b.dataset.del, {});
    if (r.status>=300) alert("delete failed: "+await r.text()); else bucketsView();
  });
}

async function objectsView(bucket, prefix){
  const r = await signedFetch("GET", "/"+bucket,
    {"list-type":"2", "prefix":prefix, "delimiter":"/"});
  if (authFailed(r)) return;
  if (r.status !== 200){
    shell("buckets", `<div class="panel err">listing ${esc(bucket)} failed: HTTP ${r.status}</div>`);
    return;
  }
  const doc = xml(await r.text());
  const dirs = [...doc.querySelectorAll("CommonPrefixes > Prefix")].map(n=>n.textContent);
  const objs = [...doc.querySelectorAll("Contents")].map(c=>({
    key: c.querySelector("Key").textContent,
    size: +c.querySelector("Size").textContent,
    mod: c.querySelector("LastModified").textContent }));
  const crumbs = [`<a data-p="">${esc(bucket)}</a>`];
  let acc = "";
  for (const part of prefix.split("/").filter(Boolean)){
    acc += part + "/";
    crumbs.push(`<a data-p="${esc(acc)}">${esc(part)}</a>`);
  }
  shell("buckets", `<div class="panel"><div class="row">
      <a id="back">&larr; buckets</a>
      <span class="crumb">${crumbs.join(" / ")}</span>
      <span style="margin-left:auto"></span>
      <input type="file" id="file">
      <button id="up">upload</button></div></div>
    <div class="panel"><table>
      <tr><th>name</th><th>size</th><th>modified</th><th></th></tr>
      ${dirs.map(d=>`<tr><td><a data-d="${esc(d)}">${esc(d.slice(prefix.length))}</a></td>
        <td></td><td></td><td></td></tr>`).join("")}
      ${objs.filter(o=>o.key!==prefix).map(o=>`<tr>
        <td>${esc(o.key.slice(prefix.length))}</td>
        <td>${fmtSize(o.size)}</td><td>${esc(o.mod)}</td>
        <td style="text-align:right">
          <button class="alt" data-get="${esc(o.key)}">download</button>
          <button class="ghost" data-rm="${esc(o.key)}">delete</button></td>
        </tr>`).join("")}
    </table></div>`);
  document.getElementById("back").onclick = ()=>bucketsView();
  app.querySelectorAll("a[data-p]").forEach(a=> a.onclick = ()=>objectsView(bucket, a.dataset.p));
  app.querySelectorAll("a[data-d]").forEach(a=> a.onclick = ()=>objectsView(bucket, a.dataset.d));
  document.getElementById("up").onclick = async ()=>{
    const f = document.getElementById("file").files[0];
    if (!f) return;
    const r = await signedFetch("PUT", `/${bucket}/${prefix}${f.name}`, {}, f);
    if (r.status!==200) alert("upload failed: "+await r.text());
    else objectsView(bucket, prefix);
  };
  app.querySelectorAll("button[data-get]").forEach(b=> b.onclick = async ()=>{
    const r = await signedFetch("GET", `/${bucket}/${b.dataset.get}`, {});
    if (r.status!==200){ alert("download failed"); return; }
    const blob = await r.blob();
    const a = document.createElement("a");
    a.href = URL.createObjectURL(blob);
    a.download = b.dataset.get.split("/").pop();
    a.click();
    URL.revokeObjectURL(a.href);
  });
  app.querySelectorAll("button[data-rm]").forEach(b=> b.onclick = async ()=>{
    if (!confirm(`delete ${b.dataset.rm}?`)) return;
    await signedFetch("DELETE", `/${bucket}/${b.dataset.rm}`, {});
    objectsView(bucket, prefix);
  });
}

async function infoView(){
  const r = await signedFetch("GET", "/minio/admin/v3/info", {});
  const text = r.status===200 ? JSON.stringify(await r.json(), null, 2)
                              : `HTTP ${r.status} (admin:ServerInfo needed)`;
  shell("info", `<div class="panel"><h3>server info</h3><pre>${esc(text)}</pre></div>`);
}

async function metricsView(){
  const r = await signedFetch("GET", "/minio/metrics/v3", {});
  const text = r.status===200 ? await r.text()
                              : `HTTP ${r.status} (admin:Prometheus needed)`;
  shell("metrics", `<div class="panel"><h3>metrics snapshot (v3)</h3><pre>${esc(text)}</pre></div>`);
}

// ---- IAM management (users + policies) ----
async function iamView(){
  const [ur, pr] = await Promise.all([
    signedFetch("GET", "/minio/console/api/users", {}),
    signedFetch("GET", "/minio/admin/v3/list-canned-policies", {})]);
  if (authFailed(ur)) return;
  const users = ur.status===200 ? await ur.json() : null;
  const pols  = pr.status===200 ? await pr.json() : {};
  const polNames = Object.keys(pols).sort();
  const userRows = users===null
    ? `<tr><td colspan="5" class="err">listing users needs admin:ListUsers (HTTP ${ur.status})</td></tr>`
    : Object.entries(users).sort().map(([ak,u])=>`<tr>
        <td>${esc(ak)}</td><td class="${u.status==="enabled"?"ok":"err"}">${esc(u.status)}</td>
        <td>${esc(u.policyName||"")}</td><td>${esc((u.memberOf||[]).join(", "))}</td>
        <td style="text-align:right">
          <select data-attachsel="${esc(ak)}">${polNames.map(p=>`<option>${esc(p)}</option>`).join("")}</select>
          <button class="alt" data-attach="${esc(ak)}">attach</button>
          <button class="ghost" data-toggle="${esc(ak)}" data-st="${esc(u.status)}">${u.status==="enabled"?"disable":"enable"}</button>
          <button class="ghost" data-deluser="${esc(ak)}">delete</button></td></tr>`).join("");
  shell("iam", `<div class="panel"><h3>users</h3>
      <div class="row"><input id="nak" placeholder="access key">
        <input id="nsk" placeholder="secret key" type="password">
        <button id="adduser">add user</button></div>
      <table><tr><th>access key</th><th>status</th><th>policies</th><th>groups</th><th></th></tr>
      ${userRows}</table></div>
    <div class="panel"><h3>policies</h3>
      <div class="row"><input id="pname" placeholder="policy name">
        <button id="addpol">create from JSON below</button></div>
      <p><textarea id="pjson" rows="6" style="width:100%;font-family:monospace"
        placeholder='{"Version":"2012-10-17","Statement":[{"Effect":"Allow","Action":["s3:*"],"Resource":["arn:aws:s3:::*"]}]}'></textarea></p>
      <table><tr><th>name</th><th></th></tr>
      ${polNames.map(p=>`<tr><td><a data-viewpol="${esc(p)}">${esc(p)}</a></td>
        <td style="text-align:right"><button class="ghost" data-delpol="${esc(p)}">delete</button></td></tr>`).join("")}
      </table><pre id="polview" style="display:none"></pre></div>`);
  document.getElementById("adduser").onclick = async ()=>{
    const ak = document.getElementById("nak").value.trim();
    const sk = document.getElementById("nsk").value;
    if (!ak || !sk) return;
    const r = await signedFetch("PUT", "/minio/admin/v3/add-user", {accessKey:ak},
      JSON.stringify({secretKey:sk, status:"enabled"}));
    if (r.status!==200) alert("add user failed: "+await r.text()); else iamView();
  };
  document.getElementById("addpol").onclick = async ()=>{
    const n = document.getElementById("pname").value.trim();
    const j = document.getElementById("pjson").value;
    if (!n || !j) return;
    const r = await signedFetch("PUT", "/minio/admin/v3/add-canned-policy", {name:n}, j);
    if (r.status!==200) alert("create policy failed: "+await r.text()); else iamView();
  };
  app.querySelectorAll("button[data-deluser]").forEach(b=> b.onclick = async ()=>{
    if (!confirm(`delete user ${b.dataset.deluser}?`)) return;
    await signedFetch("DELETE", "/minio/admin/v3/remove-user", {accessKey:b.dataset.deluser});
    iamView();
  });
  app.querySelectorAll("button[data-toggle]").forEach(b=> b.onclick = async ()=>{
    const to = b.dataset.st==="enabled" ? "disabled" : "enabled";
    await signedFetch("PUT", "/minio/admin/v3/set-user-status",
      {accessKey:b.dataset.toggle, status:to});
    iamView();
  });
  app.querySelectorAll("button[data-attach]").forEach(b=> b.onclick = async ()=>{
    const sel = app.querySelector(`select[data-attachsel="${CSS.escape(b.dataset.attach)}"]`);
    const r = await signedFetch("PUT", "/minio/admin/v3/set-user-or-group-policy",
      {policyName:sel.value, userOrGroup:b.dataset.attach, isGroup:"false"});
    if (r.status!==200) alert("attach failed: "+await r.text()); else iamView();
  });
  app.querySelectorAll("a[data-viewpol]").forEach(a=> a.onclick = ()=>{
    const pv = document.getElementById("polview");
    pv.style.display = "";
    pv.textContent = JSON.stringify(pols[a.dataset.viewpol], null, 2);
  });
  app.querySelectorAll("button[data-delpol]").forEach(b=> b.onclick = async ()=>{
    if (!confirm(`delete policy ${b.dataset.delpol}?`)) return;
    await signedFetch("DELETE", "/minio/admin/v3/remove-canned-policy", {name:b.dataset.delpol});
    iamView();
  });
}

// ---- live watch (bucket event firehose) ----
let watchAbort = null;
async function watchView(){
  shell("watch", `<div class="panel"><div class="row">
      <input id="wb" placeholder="bucket">
      <input id="wp" placeholder="prefix (optional)">
      <input id="ws" placeholder="suffix (optional)">
      <select id="we"><option>s3:ObjectCreated:*,s3:ObjectRemoved:*</option>
        <option>s3:ObjectCreated:*</option><option>s3:ObjectRemoved:*</option>
        <option>s3:ObjectAccessed:*</option></select>
      <button id="wstart">watch</button>
      <button id="wstop" class="ghost" disabled>stop</button></div></div>
    <div class="panel"><pre id="wlog" style="max-height:500px">waiting…</pre></div>`);
  const log = document.getElementById("wlog");
  const startB = document.getElementById("wstart"), stopB = document.getElementById("wstop");
  stopB.onclick = ()=>{ if (watchAbort){ watchAbort.abort(); watchAbort=null; }
    startB.disabled=false; stopB.disabled=true; };
  startB.onclick = async ()=>{
    const b = document.getElementById("wb").value.trim();
    if (!b) return;
    startB.disabled = true; stopB.disabled = false;
    log.textContent = "";
    watchAbort = new AbortController();
    // sign the request, then re-issue it with the stream abortable
    const q = {events: document.getElementById("we").value,
               prefix: document.getElementById("wp").value,
               suffix: document.getElementById("ws").value};
    try {
      const r = await signedFetch("GET", "/"+b, q, undefined, watchAbort.signal);
      if (r.status!==200){ log.textContent = `listen failed: HTTP ${r.status}`; return; }
      const reader = r.body.getReader();
      const dec = new TextDecoder();
      let buf = "";
      for (;;){
        const {done, value} = await reader.read();
        if (done) break;
        buf += dec.decode(value, {stream:true});
        let i;
        while ((i = buf.indexOf("\n")) >= 0){
          const line = buf.slice(0, i).trim(); buf = buf.slice(i+1);
          if (!line) continue;  // keep-alive
          try {
            const rec = JSON.parse(line).Records[0];
            log.textContent += `${rec.eventTime}  ${rec.eventName}  ` +
              `${rec.s3.bucket.name}/${rec.s3.object.key}  ${rec.s3.object.size??""}\n`;
          } catch(e){ log.textContent += line + "\n"; }
          log.scrollTop = log.scrollHeight;
        }
      }
    } catch(e){ if (e.name!=="AbortError") log.textContent += "\nstream error: "+e; }
    finally { startB.disabled=false; stopB.disabled=true; }
  };
}
// ---- diagnostics (health, usage, heal, locks, scanner) ----
async function diagView(){
  shell("diagnostics", `<div class="panel">loading…</div>`);
  const get = async (p, q)=>{
    const r = await signedFetch("GET", p, q||{});
    if (r.status!==200) return `HTTP ${r.status}`;
    const t = await r.text();
    try { return JSON.stringify(JSON.parse(t), null, 2); } catch(e){ return t; }
  };
  const [live, cluster, usage, heal, scanner, locks] = await Promise.all([
    fetch("/minio/health/live").then(r=>r.status),
    fetch("/minio/health/cluster").then(r=>r.status),
    get("/minio/admin/v3/datausageinfo"),
    get("/minio/admin/v3/background-heal/status"),
    get("/minio/admin/v3/scanner/status"),
    get("/minio/admin/v3/top/locks")]);
  document.getElementById("content").innerHTML = `
    <div class="panel"><h3>health</h3>
      <p>liveness: <span class="${live===200?"ok":"err"}">${live===200?"OK":"HTTP "+live}</span>
      &nbsp; cluster (write quorum): <span class="${cluster===200?"ok":"err"}">${cluster===200?"OK":"HTTP "+cluster}</span></p></div>
    <div class="panel"><h3>data usage</h3><pre>${esc(usage)}</pre></div>
    <div class="panel"><h3>heal status</h3><pre>${esc(heal)}</pre></div>
    <div class="panel"><h3>scanner</h3><pre>${esc(scanner)}</pre></div>
    <div class="panel"><h3>top locks</h3><pre>${esc(locks)}</pre></div>`;
}

document.getElementById("logout").onclick = ()=>{
  sessionStorage.removeItem("ccreds"); S.ak=S.sk=""; loginView();
};
const saved = sessionStorage.getItem("ccreds");
if (saved){ const c = JSON.parse(saved); S.ak=c.ak; S.sk=c.sk; S.token=c.token||""; mainView("buckets"); }
else loginView();
</script>
</body>
</html>
"""


def handle_console(request):
    """GET /minio/console[/...] — serve the embedded single-page console."""
    from . import web

    return web.Response(
        body=CONSOLE_HTML.encode(),
        content_type="text/html",
        headers={
            # the page signs requests with in-memory credentials: keep it
            # un-cacheable and locked down
            "Cache-Control": "no-store",
            "Content-Security-Policy": "default-src 'self' 'unsafe-inline' blob:",
            "X-Frame-Options": "DENY",
        },
    )
